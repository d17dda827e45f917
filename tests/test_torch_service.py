"""The port's ``StreamService`` against the reference package's, on the CPU
route: the sweeps of ``tests/test_service.py`` (the fleet's is in
``tests/test_torch_fleet.py``).

The same raw dict events, made from seeds, go through ``repro``'s service
over ``repro``'s engine and the port's over the port's.  Tolerance 0:
receipts, dead-letter records, ``matches.log`` records, alerts and every
metric counter must be identical; chunk latencies are the only field not
compared.  Each service's device step is held until the producer has
submitted every event, so ``queue_peak`` does not depend on thread timing.
The overflow-heal sweep keeps every count below 2^24, where f32 counts are
exact, and asserts it.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from dataclasses import dataclass

import numpy as np
import pytest

import repro.runtime as jrt
from repro.core import Event as JEvent
from repro.vector import PartitionedStreamingEngine as JPart
from repro.vector import StreamingVectorEngine as JStream
from repro.vector import VectorEngine as JVector
from repro_torch.core.events import Event as TEvent
from repro_torch.kernels.window import WindowOverflowError
from repro_torch.runtime import (DeadLetterQueue, EventValidator,
                                 QueryFleet, RetryPolicy, StreamService,
                                 TokenBucket, cumulative_matches,
                                 run_with_retries)
from repro_torch.runtime.recovery import DEFAULT_STEP_POLICY
from repro_torch.vector import PartitionedStreamingEngine as TPart
from repro_torch.vector import StreamingVectorEngine as TStream
from repro_torch.vector import VectorEngine as TVector

QT = "SELECT * FROM S WHERE A ; B+ ; C WITHIN 50 [t]"
QT_WIDE = "SELECT * FROM S WHERE A ; B+ ; C WITHIN 1000 [t]"
EXACT_LIMIT = 2 ** 24


def make_raws(seed, n, n_keys=4, dt=3.0):
    rng = np.random.default_rng(seed)
    return [{"type": "ABC"[int(rng.integers(0, 3))], "v": 1.0,
             "t": float(i) * dt, "uid": int(rng.integers(0, n_keys))}
            for i in range(n)]


def part_engine(pkg, mwe, chunk_len=16, num_lanes=8, query=QT, arena=None):
    if pkg == "repro":
        ve = JVector(query, use_pallas=False, max_window_events=mwe)
        cls = JPart
    else:
        ve = TVector(query, max_window_events=mwe, device="cpu")
        cls = TPart
    return cls(ve, ("uid",), chunk_len=chunk_len, num_lanes=num_lanes,
               arena_capacity=arena, strict_overflow=True)


def single_engine(pkg, mwe=64, batch=1):
    if pkg == "repro":
        return JStream(JVector(QT, use_pallas=False, max_window_events=mwe),
                       chunk_len=8, batch=batch, strict_overflow=True)
    return TStream(TVector(QT, max_window_events=mwe, device="cpu"),
                   chunk_len=8, batch=batch, strict_overflow=True)


SERVICE = {"repro": jrt.StreamService, "port": StreamService}
BUCKET = {"repro": jrt.TokenBucket, "port": TokenBucket}
VALIDATOR = {"repro": jrt.EventValidator, "port": EventValidator}
EVENT = {"repro": JEvent, "port": TEvent}


@dataclass
class Run:
    alerts: list
    receipts: list
    counters: dict
    files: dict        # matches.log and dead_letter.jsonl, raw bytes
    cumulative: dict


def read(directory, name):
    path = os.path.join(directory, name)
    if not os.path.exists(path):
        return b""
    with open(path, "rb") as f:
        return f.read()


def run_service(pkg, raws, directory, engine, sinks=(), hold=True,
                allowed_types=None, **kw):
    """Submit every raw event, drain with padding, close.  With ``hold``
    the device step waits until every event was submitted (the ingress is
    sized to take the whole stream), so the run does not depend on thread
    timing.  ``allowed_types`` closes the validator's type universe."""
    alerts = []
    if allowed_types is not None:
        kw["validator"] = VALIDATOR[pkg](allowed_types=allowed_types)
    kw.setdefault("queue_chunks", max(8, -(-len(raws) // engine.chunk_len)))
    svc = SERVICE[pkg](engine, directory,
                       sinks=[lambda c, h: alerts.append((c, list(h)))]
                       + list(sinks), **kw)
    gate = threading.Event()
    feed = getattr(engine, svc.adapter.feed_method)

    def held(*a, **k):
        assert gate.wait(60.0)
        return feed(*a, **k)
    setattr(engine, svc.adapter.feed_method, held)
    if not hold:
        gate.set()
    receipts = [svc.submit(r, block=True, timeout=30.0) for r in raws]
    gate.set()
    svc.drain(pad=True)
    svc.close()
    counters = {k: v for k, v in vars(svc.metrics).items()
                if k != "chunk_latency_s"}
    return Run(alerts, [(r.status, r.seq, r.reason) for r in receipts],
               counters, {n: read(directory, n) for n in
                          ("matches.log", "dead_letter.jsonl")},
               jrt.cumulative_matches(directory))


def run_both(raws, tmp_path, make_engine, **kw):
    """The same raws through both packages' services; every compared field
    equal.  Returns the port's run."""
    runs = {pkg: run_service(pkg, raws, str(tmp_path / pkg),
                             make_engine(pkg), **kw)
            for pkg in ("repro", "port")}
    assert_same_runs(runs["port"], runs["repro"])
    return runs["port"]


def assert_same_runs(a: Run, b: Run):
    assert a.receipts == b.receipts
    assert a.alerts == b.alerts
    assert a.counters == b.counters
    assert a.files == b.files
    assert a.cumulative == b.cumulative


def alert_hits(alerts):
    return sorted(h for _, hs in alerts for h in hs)


# ---------------------------------------------------------------------------
# retry policy: jitter, timeout, deny-list (the port's copy)
# ---------------------------------------------------------------------------

def test_retry_backoff_jitter_bounds(monkeypatch):
    sleeps = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] <= 3:
            raise RuntimeError("transient")
        return "ok"

    pol = RetryPolicy(max_retries=3, backoff_s=0.1, backoff_mult=2.0,
                      jitter=0.5)
    assert run_with_retries(flaky, pol) == "ok"
    assert calls[0] == 4 and len(sleeps) == 3
    for i, s in enumerate(sleeps):
        base = 0.1 * 2.0 ** i
        assert base <= s <= base * 1.5, (i, s)


def test_retry_per_attempt_timeout():
    pol = RetryPolicy(max_retries=1, backoff_s=0.01, timeout_s=0.05)
    calls = [0]

    def hang():
        calls[0] += 1
        time.sleep(5.0)

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="per-attempt timeout"):
        run_with_retries(hang, pol)
    assert time.monotonic() - t0 < 2.0
    assert calls[0] == 1                        # crash-only by default

    calls[0] = 0
    pol2 = RetryPolicy(max_retries=1, backoff_s=0.01, timeout_s=0.05,
                       retry_timeouts=True)
    with pytest.raises(TimeoutError, match="per-attempt timeout"):
        run_with_retries(hang, pol2)
    assert calls[0] == 2


def test_retry_deny_list_wins_over_retryable():
    calls = [0]

    def corrupt():
        calls[0] += 1
        raise WindowOverflowError(np.array([1]))

    pol = RetryPolicy(max_retries=5, backoff_s=0.0, retryable=(Exception,),
                      non_retryable=(WindowOverflowError, ValueError))
    with pytest.raises(WindowOverflowError):
        run_with_retries(corrupt, pol)
    assert calls[0] == 1

    calls[0] = 0

    def mismatched():
        calls[0] += 1
        raise ValueError("snapshot is incompatible")

    with pytest.raises(ValueError):
        run_with_retries(mismatched, pol)
    assert calls[0] == 1


def test_default_step_policy_denies_state_errors():
    assert WindowOverflowError in DEFAULT_STEP_POLICY.non_retryable
    assert ValueError in DEFAULT_STEP_POLICY.non_retryable
    assert RuntimeError in DEFAULT_STEP_POLICY.retryable
    assert not DEFAULT_STEP_POLICY.retry_timeouts
    assert not issubclass(WindowOverflowError, RuntimeError)


# ---------------------------------------------------------------------------
# validation + dead-letter queue
# ---------------------------------------------------------------------------

def test_validator_reasons():
    cases = ["nope", {"t": 1.0}, {"type": 7}, {"type": "Z", "t": 1.0},
             {"type": "A", "t": 1.0, "x": [1, 2]}, {"type": "A"},
             {"type": "A", "t": "late"}, {"type": "A", "t": float("nan")},
             {"type": "A", "t": 5.0}, {"type": "A", "t": 3.0},
             {"type": "A", "t": 5.0}, {"type": "A", "t": True},
             {"type": "", "t": 6.0}, {"type": "B", "t": float("inf")}]
    mine = EventValidator(allowed_types={"A", "B"}, monotone_attr="t")
    theirs = jrt.EventValidator(allowed_types={"A", "B"}, monotone_attr="t")
    got = [mine.check(c) for c in cases]
    assert got == [theirs.check(c) for c in cases]
    assert got == ["not_a_dict", "bad_type", "bad_type", "unknown_type",
                   "bad_attr_value", "missing_clock", "bad_clock",
                   "bad_clock", None, "non_monotone_clock", None,
                   "bad_clock", "bad_type", "bad_clock"]


def test_malformed_events_dead_letter_and_replay(tmp_path):
    raws = make_raws(0, 64)
    junk = [{"type": "Z", "t": 1.0, "uid": 0}, "garbage", {"v": 1}]
    feed = raws[:20] + junk + raws[20:]
    run = run_both(feed, tmp_path, lambda pkg: part_engine(pkg, 32),
                   allowed_types={"A", "B", "C"})
    bad = [r for r in run.receipts if r[0] == "rejected"]
    assert [r[2] for r in bad] == ["unknown_type", "not_a_dict", "bad_type"]
    assert run.counters["accepted"] == len(raws)
    assert run.counters["rejected"] == 3
    # the clean run over only-good events emits the same matches
    clean = run_service("port", raws, str(tmp_path / "clean"),
                        part_engine("port", 32))
    assert alert_hits(run.alerts) == alert_hits(clean.alerts)
    assert run.cumulative == clean.cumulative
    # replayed rejects (repaired) are accepted; the DLQ dedups by seq
    dlq = DeadLetterQueue(str(tmp_path / "port" / "dead_letter.jsonl"))
    recs = dlq.records
    assert [r["seq"] for r in recs] == [r[1] for r in bad]
    assert dlq.high_water() == recs[-1]["seq"]
    assert not dlq.append(recs[0]["seq"], "unknown_type", recs[0]["event"])
    seen = []
    out = dlq.replay(lambda ev: seen.append(ev) or "resubmitted",
                     transform=lambda rec: rec["event"])
    assert out == ["resubmitted"] * 3 and len(seen) == 3
    dlq.close()


def test_delivered_roots_pruned_to_plateau(tmp_path):
    """With ``prune_roots`` the engine's roots stay bounded by in-flight
    work; sampled at every delivery, the sizes equal the reference's, and
    a run without pruning emits the same alerts and keeps every root."""
    raws = make_raws(3, 512)
    sizes = {}
    engines = {}

    def make(pkg):
        engines[pkg] = eng = part_engine(pkg, 64, arena=1 << 12)
        sizes[pkg] = []
        return eng

    def sample(pkg):
        return lambda c, h: sizes[pkg].append(len(engines[pkg]._roots))

    runs = {pkg: run_service(pkg, raws, str(tmp_path / pkg), make(pkg),
                             sinks=[sample(pkg)])
            for pkg in ("repro", "port")}
    assert_same_runs(runs["port"], runs["repro"])
    assert sizes["port"] == sizes["repro"] and len(sizes["port"]) > 8
    eng2 = part_engine("port", 64, arena=1 << 12)
    kept = run_service("port", raws, str(tmp_path / "kept"), eng2,
                       prune_roots=False)
    assert kept.counters["alerts"] == runs["port"].counters["alerts"] > 0
    assert kept.cumulative == runs["port"].cumulative
    assert len(eng2._roots) == len({h for _, hs in kept.alerts for h in hs})
    assert max(sizes["port"]) < len(eng2._roots) / 4
    last_chunk = max(c for c, hs in kept.alerts if hs)
    assert all(p >= (last_chunk + 1) * 16 for p in engines["port"]._roots)


def test_dlq_torn_tail_repair(tmp_path):
    for pkg, cls in (("port", DeadLetterQueue),
                     ("repro", jrt.DeadLetterQueue)):
        dlq = cls(str(tmp_path / f"{pkg}.jsonl"))
        dlq.append(0, "bad_type", {"x": 1})
        dlq.append(4, "unknown_type", {"type": "Z"})
        dlq.append(5, "bad_attr_value", {"type": "A", "x": {1, 2}})
        dlq.close()
        with open(tmp_path / f"{pkg}.jsonl", "a") as f:
            f.write('{"seq": 9, "torn')
    dlq2 = DeadLetterQueue(str(tmp_path / "repro.jsonl"))
    assert [r["seq"] for r in dlq2.records] == [0, 4, 5]
    assert dlq2.high_water() == 5
    assert dlq2.append(9, "bad_clock", {})
    dlq2.close()
    dlq3 = DeadLetterQueue(str(tmp_path / "port.jsonl"))
    assert dlq3.append(9, "bad_clock", {})
    dlq3.close()
    assert read(tmp_path, "port.jsonl") == read(tmp_path, "repro.jsonl")


# ---------------------------------------------------------------------------
# admission control / backpressure
# ---------------------------------------------------------------------------

def test_token_bucket_refill():
    tb = TokenBucket(rate=1.0, burst=2.0)
    assert tb.allow("t", now=0.0) and tb.allow("t", now=0.0)
    assert not tb.allow("t", now=0.0)
    assert tb.allow("t", now=1.0)
    assert not tb.allow("t", now=1.0)
    assert tb.allow("other", now=0.0)


def test_backpressure_sheds_exactly_the_over_limit_tenant(tmp_path):
    rng = np.random.default_rng(4)
    raws, t = [], 0.0
    for i in range(96):
        tenant = "noisy" if i % 3 != 2 else "quiet"
        raws.append({"type": "ABC"[int(rng.integers(0, 3))],
                     "t": (t := t + 2.0), "uid": 0, "tenant": tenant})
    runs = {}
    for pkg in ("repro", "port"):
        runs[pkg] = run_service(
            pkg, raws, str(tmp_path / pkg), part_engine(pkg, 64, chunk_len=8),
            admission=BUCKET[pkg](rate=0.0, burst=24), tenant_attr="tenant")
    assert_same_runs(runs["port"], runs["repro"])
    run = runs["port"]
    for tenant in ("noisy", "quiet"):
        stats = [rc[0] for r, rc in zip(raws, run.receipts)
                 if r["tenant"] == tenant]
        assert stats[:24] == ["accepted"] * 24
        assert all(s == "shed_rate" for s in stats[24:])
    admitted = [r for r, rc in zip(raws, run.receipts) if rc[0] == "accepted"]
    assert len(admitted) == 48 and run.counters["shed_rate"] == 48
    dlq = DeadLetterQueue(str(tmp_path / "port" / "dead_letter.jsonl"))
    assert sorted(r["seq"] for r in dlq.records) == \
        sorted(rc[1] for rc in run.receipts if rc[0] == "shed_rate")
    dlq.close()
    oracle = run_service("port", admitted, str(tmp_path / "oracle"),
                         part_engine("port", 64, chunk_len=8))
    assert alert_hits(run.alerts) == alert_hits(oracle.alerts)


def test_backpressure_shed_and_block_timeout(tmp_path):
    """With the device thread wedged, a full ingress buffer sheds
    non-blocking submits and times out blocking ones."""
    gate = threading.Event()
    matching = [{"type": t, "t": float(i) * 1.0, "uid": 0}
                for i, t in enumerate("ABC" * 8)]
    engine = part_engine("port", 64, chunk_len=4, num_lanes=2)
    svc = StreamService(engine, str(tmp_path / "bp"),
                        sinks=[lambda c, h: gate.wait(30.0)], queue_chunks=1)
    try:
        got = [svc.submit(r, block=True, timeout=30.0)
               for r in matching[:4]]
        assert all(r.accepted for r in got)
        deadline = time.monotonic() + 30.0
        r = svc.submit(matching[4])
        while r.accepted and time.monotonic() < deadline:
            r = svc.submit(matching[4])
        assert r.status == "shed_backpressure"
        assert svc.metrics.shed_backpressure >= 1
        r = svc.submit(matching[4], block=True, timeout=0.05)
        assert r.status == "timeout"
        assert svc.metrics.block_timeouts == 1
    finally:
        gate.set()
        svc.drain(pad=True)
        svc.close()


def test_drain_without_pad_leaves_tail_pending(tmp_path):
    raws = make_raws(12, 32)
    svc = StreamService(part_engine("port", 64), str(tmp_path / "tail"))
    try:
        for r in raws[:20]:
            assert svc.submit(r, block=True, timeout=30.0).accepted
        t0 = time.monotonic()
        svc.drain(timeout=30.0)
        assert time.monotonic() - t0 < 10.0
        assert svc.metrics.chunks == 1
        assert len(svc._pending) == 4
        for r in raws[20:]:
            assert svc.submit(r, block=True, timeout=30.0).accepted
        svc.drain(timeout=30.0)
        assert svc.metrics.chunks == 2
    finally:
        svc.close()


@pytest.mark.parametrize("restart", ["repro", "port"])
def test_restart_replays_admission_decisions(restart, tmp_path):
    """A producer replay reproduces the original admission decisions under
    a tighter bucket; the first run is the reference's, the restart over
    its directory either package's."""
    rng = np.random.default_rng(8)
    raws, t = [], 0.0
    for _ in range(64):
        raws.append({"type": "ABC"[int(rng.integers(0, 3))],
                     "t": (t := t + 2.0), "uid": 0})
    d = str(tmp_path / "replay-shed")
    first = run_service("repro", raws, d,
                        part_engine("repro", 64, chunk_len=8),
                        admission=jrt.TokenBucket(rate=0.0, burst=40))
    assert first.counters["shed_rate"] == 24
    again = run_service(restart, raws, d,
                        part_engine(restart, 64, chunk_len=8),
                        admission=BUCKET[restart](rate=0.0, burst=16))
    assert again.receipts == first.receipts
    assert again.counters["skipped_chunks"] == 5
    assert again.cumulative == first.cumulative == cumulative_matches(d)
    if restart == "port":
        ref = run_service("repro", raws, str(tmp_path / "ref"),
                          part_engine("repro", 64, chunk_len=8),
                          admission=jrt.TokenBucket(rate=0.0, burst=40))
        run_service("repro", raws, str(tmp_path / "ref"),
                    part_engine("repro", 64, chunk_len=8),
                    admission=jrt.TokenBucket(rate=0.0, burst=16))
        assert read(tmp_path / "ref", "matches.log") == \
            read(d, "matches.log")
        assert ref.files["dead_letter.jsonl"] == \
            read(d, "dead_letter.jsonl")


# ---------------------------------------------------------------------------
# service overflow self-healing
# ---------------------------------------------------------------------------

def test_service_overflow_self_heals_to_oracle_parity(tmp_path):
    """Forced WindowOverflowError (one window over the whole stream at a
    ring of 8): the port's service quarantines, regrows through the
    checkpointed restore path and replays; its match set equals a port
    service and a reference service sized large from the start.  Every
    count stays below 2^24, where f32 counts are exact."""
    raws = make_raws(3, 128, n_keys=4, dt=1.0)
    small = run_service("port", raws, str(tmp_path / "small"),
                        part_engine("port", 8, num_lanes=4, query=QT_WIDE),
                        checkpoint_every=4, max_window_events_cap=512)
    big = run_service("port", raws, str(tmp_path / "big"),
                      part_engine("port", 256, num_lanes=4, query=QT_WIDE),
                      checkpoint_every=4)
    ref = run_service("repro", raws, str(tmp_path / "ref"),
                      part_engine("repro", 256, num_lanes=4, query=QT_WIDE),
                      checkpoint_every=4)
    assert_same_runs(big, ref)
    assert small.counters["overflows"] >= 1 and small.counters["regrows"] >= 1
    assert big.counters["overflows"] == 0
    counts = small.cumulative["counts"]
    assert counts and max(counts.values()) < EXACT_LIMIT
    assert small.alerts == big.alerts
    assert small.cumulative == big.cumulative


def test_service_resumes_interrupted_heal_from_sidecar(tmp_path):
    """A crash between the sidecar write and the completed regrow resumes
    the heal on restart, in either package, over the reference's
    directory."""
    raws = make_raws(6, 64, n_keys=2, dt=20.0)
    more = [{"type": r["type"], "t": r["t"] + 10000.0, "uid": r["uid"]}
            for r in make_raws(7, 32, n_keys=2, dt=20.0)]
    out = {}
    for pkg in ("repro", "port"):
        d = str(tmp_path / pkg)
        engine = part_engine("repro", 8, num_lanes=4)
        first = run_service("repro", raws, d, engine, checkpoint_every=4)
        assert first.counters["overflows"] == 0 and engine.window.ring == 8
        with open(os.path.join(d, "service_state.json"), "w") as f:
            json.dump({"max_window_events": 16, "quarantined": [1]}, f)
        engine2 = part_engine(pkg, 8, num_lanes=4)
        svc = SERVICE[pkg](engine2, d, checkpoint_every=4)
        assert engine2.window.ring == 16
        assert engine2.quarantined_lanes == ()
        with open(os.path.join(d, "service_state.json")) as f:
            assert json.load(f) == {"max_window_events": 16,
                                    "quarantined": []}
        for r in raws + more:
            assert svc.submit(r, block=True, timeout=30.0).accepted
        svc.drain(pad=True)
        svc.close()
        assert svc.metrics.skipped_chunks > 0 and svc.metrics.chunks > 0
        out[pkg] = ({k: v for k, v in vars(svc.metrics).items()
                     if k not in ("chunk_latency_s", "queue_peak")},
                    read(d, "matches.log"))
    assert out["port"] == out["repro"]


# ---------------------------------------------------------------------------
# kill -9 under the service loop: exactly-once emission + alert dedup
# ---------------------------------------------------------------------------

_KILL9_DRIVER = textwrap.dedent("""
    import json, os, signal, sys
    import numpy as np
    from repro_torch.vector import PartitionedStreamingEngine, VectorEngine
    from repro_torch.runtime import StreamService

    d, crash_after = sys.argv[1], int(sys.argv[2])
    ve = VectorEngine("SELECT * FROM S WHERE A ; B+ ; C WITHIN 60 [t]",
                      max_window_events=32, device="cpu")
    pe = PartitionedStreamingEngine(ve, ("uid",), chunk_len=8, num_lanes=4,
                                    strict_overflow=True)
    alert_path = os.path.join(d, "alerts.jsonl")
    n = [0]
    def sink(chunk, hits):
        with open(alert_path, "a") as f:
            f.write(json.dumps({"chunk": chunk, "hits": hits}) + "\\n")
            f.flush()
            os.fsync(f.fileno())
        n[0] += 1
        if crash_after >= 0 and n[0] >= crash_after:
            os.kill(os.getpid(), signal.SIGKILL)   # kill -9 mid-chunk
    svc = StreamService(pe, d, sinks=[sink], checkpoint_every=2)
    for r in json.loads(sys.argv[3]):
        svc.submit(r, block=True, timeout=60.0)
    svc.drain(pad=True, timeout=120.0)
    svc.close()
    print("DONE")
""")


def kill9_raws():
    rng = np.random.default_rng(5)
    return [{"type": "ABC"[int(rng.integers(0, 3))], "t": float(i) * 2.0,
             "uid": int(rng.integers(0, 2))} for i in range(144)]


def test_service_kill9_exactly_once_alerts(tmp_path):
    """The driver imports only ``repro_torch``.  After a SIGKILL in a
    sink and a restart, the durable match record and the alerts deduplicated
    by chunk equal an uninterrupted run of the reference's service."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [p for p in [src, os.environ.get("PYTHONPATH")] if p]))
    script = str(tmp_path / "driver.py")
    with open(script, "w") as f:
        f.write(_KILL9_DRIVER)
    raws = kill9_raws()
    ref = run_service("repro", raws, str(tmp_path / "ref"),
                      part_engine("repro", 32, chunk_len=8, num_lanes=4,
                                  query=QT.replace("50", "60")),
                      checkpoint_every=2, hold=False)
    assert ref.cumulative["hits"]

    d = str(tmp_path / "crashed")
    os.makedirs(d)
    arg = json.dumps(raws)
    first = subprocess.run([sys.executable, script, d, "3", arg], env=env,
                           capture_output=True, text=True, timeout=600)
    assert first.returncode == -signal.SIGKILL, first.stderr
    second = subprocess.run([sys.executable, script, d, "-1", arg], env=env,
                            capture_output=True, text=True, timeout=600)
    assert second.returncode == 0, second.stderr
    assert cumulative_matches(d) == ref.cumulative

    delivered = {}
    with open(os.path.join(d, "alerts.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["chunk"] in delivered:     # a duplicate is identical
                assert delivered[rec["chunk"]] == rec["hits"]
            delivered[rec["chunk"]] = rec["hits"]
    assert delivered == {c: hs for c, hs in ref.alerts}


# ---------------------------------------------------------------------------
# single-stream adapter, refusals
# ---------------------------------------------------------------------------

def test_service_single_stream_adapter(tmp_path):
    raws = make_raws(9, 96, dt=4.0)
    for r in raws:
        del r["uid"]
    pads = {pkg: EVENT[pkg]("X", {"t": raws[-1]["t"] + 1.0})
            for pkg in ("repro", "port")}
    runs = {pkg: run_service(pkg, raws, str(tmp_path / pkg),
                             single_engine(pkg), pad_event=pads[pkg])
            for pkg in ("repro", "port")}
    assert_same_runs(runs["port"], runs["repro"])
    run = runs["port"]
    assert all(r[0] == "accepted" for r in run.receipts)
    assert run.counters["chunks"] == 12
    # the direct engine feed over the same stream gives the same hits
    se = single_engine("port")
    evs = [TEvent(r["type"], {k: v for k, v in r.items() if k != "type"})
           for r in raws]
    want = []
    for lo in range(0, len(evs), 8):
        want.extend(se.feed([evs[lo:lo + 8]])[1])
    assert alert_hits(run.alerts) == sorted(want)


def test_single_stream_drain_pad_requires_pad_event(tmp_path):
    svc = StreamService(single_engine("port", mwe=16),
                        str(tmp_path / "nopad"))
    assert svc.submit({"type": "A", "t": 0.0}).accepted
    with pytest.raises(ValueError, match="pad_event"):
        try:
            svc.drain(pad=True)
        finally:
            svc.close(checkpoint=False)


def test_service_refuses_batches_and_other_engines(tmp_path):
    with pytest.raises(ValueError, match="ONE raw stream"):
        StreamService(single_engine("port", batch=2), str(tmp_path / "b2"))
    for other in (object(), part_engine("repro", 16)):
        with pytest.raises(TypeError, match="no StreamService adapter"):
            StreamService(other, str(tmp_path / "other"))
    with pytest.raises(ValueError, match="ONE raw stream"):
        StreamService(QueryFleet(chunk_len=8, batch=2, device="cpu"),
                      str(tmp_path / "fleet2"))
    with pytest.raises(ValueError, match="strict_overflow"):
        StreamService(TPart(TVector(QT, max_window_events=16, device="cpu"),
                            ("uid",), chunk_len=8, num_lanes=2),
                      str(tmp_path / "lax"))
    with pytest.raises(ValueError, match="overflow_policy"):
        StreamService(part_engine("port", 16), str(tmp_path / "p"),
                      overflow_policy="ignore")
