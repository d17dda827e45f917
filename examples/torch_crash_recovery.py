"""Crash-recovery smoke of the PyTorch port: kill -9 a streaming worker
between chunks, restart it on the same recovery directory, and check that
the cumulative emitted match set is bit-identical to an uninterrupted run
(DESIGN.md §10).

    PYTHONPATH=src python examples/torch_crash_recovery.py [--device cpu]

The engines run on the CUDA device (the lane-routing, fused-scan and
arena-store kernels) unless ``--device cpu`` asks for the plain PyTorch
versions.  Three runs of the same deterministic PARTITION BY workload
(NULL keys and missing attributes included, tECS arena on):

1. an in-process *oracle* run that never crashes;
2. a worker subprocess that checkpoints every 4 chunks and SIGKILLs itself
   mid-interval (after chunk 11: checkpoints at 4 and 8, emission log
   through 10 — the checkpoint is deliberately BEHIND the log);
3. the same worker restarted: it resumes from the newest checkpoint,
   re-feeds chunks 8..10 with emission suppressed by the durable
   high-water mark (each replayed chunk checked against its record), then
   completes the stream.

Exit is nonzero if the worker survives the kill, the restart fails, or the
cumulative match sets differ.
"""
import argparse
import os
import signal
import subprocess
import sys
import tempfile

QTEXT = "SELECT * FROM S WHERE A ; B+ ; C WITHIN 5 events"
TOTAL, CHUNK, EVERY, CRASH_AFTER = 320, 16, 4, 11


def make_stream():
    import random

    from repro_torch.core.events import Event
    rng = random.Random(9)
    return [Event(rng.choice("ABCX"),
                  {} if rng.random() < 0.05
                  else {"uid": rng.choice(["u1", "u2", 7, None])})
            for _ in range(TOTAL)]


def make_engine(device):
    from repro_torch.vector import PartitionedStreamingEngine, VectorEngine
    return PartitionedStreamingEngine(
        VectorEngine(QTEXT, device=device), ("uid",), chunk_len=CHUNK,
        num_lanes=8, arena_capacity=1 << 12)


def run_worker(directory: str, crash_after: int, device) -> None:
    from repro_torch.runtime import RecoveringStreamRunner
    stream = make_stream()
    chunks = [stream[lo:lo + CHUNK] for lo in range(0, TOTAL, CHUNK)]
    runner = RecoveringStreamRunner(make_engine(device), directory,
                                    every=EVERY)
    resumed = runner.resume()
    print("worker: " + (f"resumed at chunk {runner.chunk_index}" if resumed
                        else "fresh start"), flush=True)
    replayed = 0
    for ch in chunks[runner.chunk_index:]:
        _, _, emitted = runner.process(ch)   # a divergent replay raises
        replayed += not emitted
        if runner.chunk_index == crash_after:
            print(f"worker: kill -9 after chunk {crash_after - 1}",
                  flush=True)
            os.kill(os.getpid(), signal.SIGKILL)   # no close(), no cleanup
    runner.close()
    print(f"worker: completed all {len(chunks)} chunks, {replayed} replayed "
          "and checked against the emission log", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", metavar="DIR", default=None)
    ap.add_argument("--crash-after", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args()
    if args.worker:
        run_worker(args.worker, args.crash_after, args.device)
        return

    from repro_torch.runtime import RecoveringStreamRunner, cumulative_matches
    stream = make_stream()
    chunks = [stream[lo:lo + CHUNK] for lo in range(0, TOTAL, CHUNK)]
    with tempfile.TemporaryDirectory() as tmp:
        d_ref = os.path.join(tmp, "uninterrupted")
        runner = RecoveringStreamRunner(make_engine(args.device), d_ref,
                                        every=EVERY)
        for ch in chunks:
            runner.process(ch)
        runner.close()
        oracle = cumulative_matches(d_ref)
        assert oracle["hits"], "workload produced no matches"

        d = os.path.join(tmp, "crashed")
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", d]
        if args.device is not None:
            cmd += ["--device", args.device]
        p = subprocess.run(cmd + ["--crash-after", str(CRASH_AFTER)])
        if p.returncode != -signal.SIGKILL:
            sys.exit(f"expected the worker to die by SIGKILL, "
                     f"got rc={p.returncode}")
        p = subprocess.run(cmd)
        if p.returncode != 0:
            sys.exit(f"restarted worker failed: rc={p.returncode}")
        got = cumulative_matches(d)
        if got != oracle:
            sys.exit("cumulative match set after kill -9 + restart differs "
                     "from the uninterrupted run — exactly-once replay is "
                     "broken")
        print(f"crash recovery OK: SIGKILL after chunk {CRASH_AFTER - 1}, "
              f"restart resumed from the checkpoint and re-emitted nothing; "
              f"{len(oracle['hits'])} hit positions bit-identical to the "
              f"uninterrupted run")


if __name__ == "__main__":
    main()
