#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; everything else is found by name under ``bench/``:

- ``workloads/<cell>.json``: its configuration, the entry it drives, its
  traffic generator and parameters and the bounds of its work;
- ``configs/<config>.json``: queries, window, precision, the reference
  that judges them, lanes, chunk, lane cap;
- ``entries/<entry>.py``: builds the program's engine and feeds it
  (``entries/control.py`` puts the reference in the program's place);
- ``traffic/<generator>.py``: makes the traffic on the card from the seed;
- ``reference/<reference>.py``: the plain reference and the comparison
  that decides ``correct``;
- ``metrics/<metric>.py``: one reader per metric of ``BENCHMARK.json``;
- ``bounds/<name>.py``: the least time of one feed's work on the card.

A run makes its traffic, builds the engine, feeds until every
substream's window is full (set-up), then feeds back to back for
``--seconds`` (each feed handed in when the previous one has returned),
and last compares what the window produced with the reference.  With
``--trace 1`` the first ``trace_seconds`` of the window run under
``torch.profiler`` with a ``feed`` span around each feed, and the line
carries the per-layer metrics.  The last line of standard output is one
JSON object; the numbers compared, each with its limit, are the last
lines of standard error and the last key of that object.
"""
import argparse
import contextlib
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level modules no run may hold: JAX and the JAX package of the repo
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """Wall-clock time at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return time.time()
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


def mark(split: dict, name: str, t_start: float) -> None:
    """Record under ``name`` the seconds since the last mark."""
    split[name] = time.time() - t_start - sum(split.values())


def warm_feeds(traffic, cfg) -> int:
    """Set-up feeds: until every substream's window is full, and two
    more."""
    return traffic.fill_feeds(cfg["window"]) + 2


def sample_of(seed: int, share: float):
    """Which window feeds (counted from the window's first) have their
    outputs kept for the comparison: a draw from the seed."""
    import numpy as np
    pick = np.random.default_rng([seed, 1]).random(1 << 16) < share
    return lambda i: bool(pick[i % pick.size])


def load(kind: str, name: str):
    """The module ``bench/<kind>/<name>.py``."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cell_metrics(spec: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]


class Card:
    """Synchronise and read memory on the run's device (no-ops on the CPU,
    where the tests drive the harness)."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def allocated(self) -> int:
        return self.torch.cuda.memory_allocated() if self.cuda else 0

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated() if self.cuda else 0

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def empty_cache(self):
        if self.cuda:
            self.torch.cuda.empty_cache()


def feed_window(entry, k0, seconds, keep, trace_seconds, prof):
    """Feed from feed ``k0`` until ``seconds`` have passed.  Every feed's
    latency and hit count is recorded, and the outputs of the feeds
    ``keep(k)`` picks (and of the last).  While ``prof`` is given, the
    first ``trace_seconds`` run under it with a ``feed`` span a feed."""
    from torch.profiler import record_function
    lat, hit_lens, kept, traced = [], {}, {}, []
    k = k0
    t0 = now = time.perf_counter()
    while now - t0 < seconds or k == k0:
        if prof is not None and now - t0 >= trace_seconds:
            prof.stop()
            prof = None
        span = (record_function("feed") if prof is not None
                else contextlib.nullcontext())
        a = time.perf_counter()
        with span:
            out = entry.feed(k)
        now = time.perf_counter()
        lat.append(now - a)
        hit_lens[k] = entry.n_hits(out)
        if prof is not None:
            traced.append(k)
        if keep(k):
            kept[k] = out
        k += 1
    kept[k - 1] = out
    if prof is not None:
        prof.stop()
    return SimpleNamespace(latencies=lat, seconds=now - t0, hit_lens=hit_lens,
                           kept=kept, traced=traced, n_fed=k)


def reduce_trace(path, traced, cell, cfg, traffic):
    """Per-layer metric context from the profiler's trace."""
    from bench.timeline import Timeline
    tl = Timeline.from_file(path)
    spans = tl.spans.get("feed", [])
    cache = {}

    def bound(name, k):
        key = (name, traffic.chunk_of(k))
        if key not in cache:
            cache[key] = load("bounds", name).seconds(traffic, cfg, k)
        return cache[key]

    feeds = list(zip(spans, traced))
    return SimpleNamespace(tl=tl, feeds=feeds, cell=cell, cfg=cfg,
                           traffic=traffic, bound=bound)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             spec: dict, device="cuda", entry=None, cfg_override=None,
             traffic_override=None, t_start=None, split=None) -> dict:
    """One run of cell ``name``: the result object, its last key
    ``checks`` holding each number compared with its limit.  ``entry``
    names another entry than the cell's, as the control does."""
    import torch
    t_start = time.time() if t_start is None else t_start
    card = Card(torch, device)
    cell = load_json("workloads", name)
    cfg = {**load_json("configs", cell["config"]), **(cfg_override or {})}
    params = {**cell["traffic"], **(traffic_override or {})}
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF

    # --- set-up: traffic, engine, the traffic in the program's form -------
    split = dict(split or {})
    mark(split, "to_harness", t_start)
    m0 = card.allocated()
    traffic = load("traffic", params["generator"]).Traffic(
        params, cfg, seed, device)
    card.sync()
    harness_bytes = card.allocated() - m0
    mark(split, "traffic", t_start)
    entry_mod = load("entries", entry or cell["entry"])
    mark(split, "import_program", t_start)
    entry = entry_mod.Entry(cfg, traffic, device)
    card.sync()
    mark(split, "engine", t_start)
    m1 = card.allocated()
    entry.make_pool()
    card.sync()
    harness_bytes += card.allocated() - m1
    mark(split, "pool", t_start)
    fill = warm_feeds(traffic, cfg)
    entry.feed(0)
    card.sync()
    mark(split, "first_feed", t_start)
    for k in range(1, fill):
        entry.feed(k)
    card.sync()
    mark(split, "warm_up", t_start)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if card.cuda else [])
        prof = profile(activities=acts)
        prof.start()
    setup_peak = card.peak()
    card.reset_peak()
    keep = sample_of(seed, cell["check"]["sample_share"])
    setup_s = time.time() - t_start
    split["profiler_and_rest"] = setup_s - sum(split.values())
    print(json.dumps({"setup_split_s": split, "warm_up_feeds": fill}),
          file=sys.stderr, flush=True)

    # --- the measured window ---------------------------------------------
    counters = {"set_up": entry.counters()}
    win = feed_window(entry, fill, seconds, lambda k: keep(k - fill),
                      cell.get("trace_seconds", seconds), prof)
    card.sync()
    window_peak = card.peak()

    # --- per-layer context from the trace -----------------------------------
    trace_ctx = None
    if trace:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            trace_ctx = reduce_trace(path, win.traced, cell, cfg, traffic)
        finally:
            os.unlink(path)
        del prof

    # --- what decides correct: the window's outputs against the reference
    counters["window"] = entry.counters()
    print(json.dumps({"program_counters": counters,
                      "window_feeds": len(win.latencies)}, default=str),
          file=sys.stderr, flush=True)
    t_judge = time.time()
    state = entry.final()
    checks = dict(entry.checks(win.n_fed))
    kept = {k: entry.normalize(out) for k, out in win.kept.items()}
    entry.close()
    del entry, win.kept
    gc.collect()
    card.empty_cache()
    judged = SimpleNamespace(cfg=cfg, traffic=traffic, kept=kept,
                             hit_lens=win.hit_lens, n_fed=win.n_fed,
                             ring=state["ring"],
                             lane_keys=state.get("lane_keys"))
    checks.update(load("reference", cfg["reference"]).compare(judged))
    failed = len(judged.failed_feeds)
    print(json.dumps({"judge_s": time.time() - t_judge,
                      "feeds_compared": len(kept)}),
          file=sys.stderr, flush=True)
    del state, judged, kept

    # --- the metrics -----------------------------------------------------
    if trace:
        ctx, kind = trace_ctx, "per_layer"
    else:
        ctx = SimpleNamespace(
            latencies=win.latencies, window_s=win.seconds,
            events=len(win.latencies) * traffic.events_per_feed,
            peak_bytes=window_peak - harness_bytes, setup_s=setup_s)
        kind = "end_to_end"
    metrics = {}
    for m in cell_metrics(spec, name, kind):
        value = load("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    chips = next(w["chips"] for w in spec["workloads"] if w["name"] == name)
    dev = {"platform": "gpu" if card.cuda else "cpu",
           "kind": torch.cuda.get_device_name() if card.cuda else "cpu",
           "count": chips,
           "memory_peak_bytes": max(setup_peak, window_peak)}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": len(win.latencies), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and ctx.feeds:
        a, b = ctx.feeds[0][0][0], ctx.feeds[-1][0][1]
        dev["busy_s"] = ctx.tl.busy(a, b)
        dev["window_s"] = b - a
        result["breakdown"] = ctx.tl.breakdown(a, b, ("feed",))
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    t_start = process_start()
    split = {}
    mark(split, "interpreter", t_start)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's build and kernel caches: fixed paths in the checkout
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    # Python's bytecode too: where the environment turns writing it off
    # and the installed packages ship none, every process compiles
    # torch's two thousand sources anew, seconds of set-up and most of
    # its spread
    sys.pycache_prefix = str(build / "pycache")
    sys.dont_write_bytecode = False
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    with open(ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    mark(split, "arguments", t_start)
    import torch
    mark(split, "import_torch", t_start)
    # one process, one host thread for the program's CPU operators: the
    # feeds' host side is single-threaded Python and NumPy, and idle
    # operator threads only contend with it for the host's cores
    torch.set_num_threads(1)
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    mark(split, "cuda_init", t_start)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), spec=spec, t_start=t_start,
                      split=split)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
