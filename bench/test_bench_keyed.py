"""The keyed cell ``debs14_plugs_pack4.output`` on the CPU: its
configuration against ``seq3_pack4``'s and the Binomial reckoning of its
lane cap; a tiny run through ``run_cell`` judged correct by the plain
reference, with the four queries packed; the judge's verdict on faults
planted under ``feed_keyed`` and on the bfloat16 control; the readers of
the ``streaming.*`` spans that ``feed_keyed`` records and of the lane
router's roofline on hand-made timelines.  Items are looped over inside
a few tests: a file of 16 tests or fewer queues after the suite's larger
files under xdist's ``--dist loadfile``."""
import json
import math
import re
from types import SimpleNamespace

import pytest
import torch

from bench import run as bench_run
from bench.timeline import Timeline

SPEC = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
CELL = "debs14_plugs_pack4.output"
CFG = bench_run.load_json("configs", "debs14_plugs_pack4")
#: a few keys, the lane cap below the chunk, a window the CPU runs at once
TINY = ({"lanes": 6, "chunk": 256, "window": 40, "lane_cap": 96},
        {"uids": 6, "pool_chunks": 5})
SEED = 2 ** 33 + 17
#: about what one H100 block may take beside the scan's static arrays
H100_LIMIT = 220_000
CSRC = bench_run.ROOT / "src" / "repro_torch" / "kernels" / "csrc"


def tiny_run(seed=SEED, trace=False, **kw):
    cfg, traffic = TINY
    return bench_run.run_cell(CELL, seed, 0.05, trace, spec=SPEC,
                              device="cpu", cfg_override=cfg,
                              traffic_override=traffic, **kw)


def test_the_configuration_is_seq3_pack4s_queries_by_plug():
    base = bench_run.load_json("configs", "seq3_pack4")
    for key in ("query", "queries", "window", "precision", "semantics",
                "reference"):
        assert CFG[key] == base[key], key
    assert (CFG["lanes"], CFG["chunk"], CFG["lane_cap"]) == (2125, 262144,
                                                             208)
    assert CFG["key_attrs"] == ["house_id", "household_id", "plug_id"]
    assert CFG["reduced"] == []
    cell = bench_run.load_json("workloads", CELL)
    assert cell["entry"] == "partitioned"
    assert cell["traffic"]["uids"] == CFG["lanes"]
    assert cell["traffic"]["null_share"] == 0.0
    # the packed engine at the cell's size: Shat = 28 over a ring split in
    # two shares of shared memory (the card's plan, read from its counters)
    from bench import program
    from repro_torch.kernels.fused_scan import plan_ring, ring_share_bytes
    eng = program.engine(CFG, "cpu")
    assert (eng.packed_states, eng.ring) == (28, 3208)
    assert plan_ring(eng.ring, 28, False, H100_LIMIT, latest=False,
                     consume=False) == (True, 2)
    ring_bytes = CFG["lanes"] * eng.ring * 28 * 4
    assert ring_bytes == 763_504_000
    assert ring_share_bytes(eng.ring, 28, False) > H100_LIMIT


def test_the_lane_cap_holds_a_pool_without_spill():
    """A plug's events in a feed are Binomial(chunk, 1/plugs): at the cap a
    pool of 128 chunks spills with probability under 1e-6, at 16 fewer
    about once in 900 pools."""
    n, p = CFG["chunk"], 1 / CFG["lanes"]
    draws = CFG["lanes"] * bench_run.load_json(
        "workloads", CELL)["traffic"]["pool_chunks"]

    def tail(cap):
        return sum(math.exp(math.lgamma(n + 1) - math.lgamma(k + 1)
                            - math.lgamma(n - k + 1) + k * math.log(p)
                            + (n - k) * math.log1p(-p))
                   for k in range(cap + 1, cap + 400))

    def per_pool(cap):
        return -math.expm1(draws * math.log1p(-tail(cap)))

    assert n * p == pytest.approx(123.36, abs=0.01)
    assert per_pool(CFG["lane_cap"]) == pytest.approx(3.9e-7, rel=0.02)
    assert per_pool(CFG["lane_cap"] - 16) == pytest.approx(1.1e-3, rel=0.02)


def test_the_cell_is_correct_at_a_tiny_size(monkeypatch):
    """Four packed queries, six plugs in six lanes, 96 of a chunk's 256
    events a lane at most.  Every scan is asked to split the ring in two
    at per-lane positions and fills: on the CPU that only passes the
    checks on ``split`` before the plain version runs, so no split ring
    runs here; ``chip_smoke.py`` phase 13c holds the split kernel at this
    cell's size against the plain version on the card."""
    from repro_torch.kernels import ops
    seen = []
    orig = ops.cer_pipeline

    def split_scan(*args, **kw):
        seen.append((args[5].shape[0], args[0].shape[:2],
                     kw["start_pos"].shape, kw["valid_counts"].shape))
        return orig(*args, **{**kw, "split": 2})
    monkeypatch.setattr(ops, "cer_pipeline", split_scan)
    res = tiny_run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert set(res["checks"]) == {"spilled_or_evicted", "routed_wrong",
                                  "counts_wrong", "hits_wrong",
                                  "hit_totals_wrong", "ring_slots_wrong"}
    assert set(seen) == {(4, (96, 6), (6,), (6,))}
    assert set(res["metrics"]) == {
        m["name"] for m in bench_run.cell_metrics(SPEC, CELL, "end_to_end")}


def start_pos_off_by_one(ops, monkeypatch):
    """Lane 0 is scanned one position on from where its substream is."""
    orig = ops.cer_pipeline

    def step(*args, **kw):
        start = kw["start_pos"].clone()
        start[0] += 1
        return orig(*args, **{**kw, "start_pos": start})
    monkeypatch.setattr(ops, "cer_pipeline", step)


def one_routed_event_dropped(ops, monkeypatch):
    """The first routed event of every chunk is left out of its lane."""
    orig = ops.lane_route

    def route(keys, lane_keys, lane_last, **kw):
        r = orig(keys, lane_keys, lane_last, **kw)
        lane = r.lane.clone()
        lane[int(torch.nonzero(lane < lane_keys.shape[0])[0, 0])] = \
            lane_keys.shape[0]
        return r._replace(lane=lane)
    monkeypatch.setattr(ops, "lane_route", route)


@pytest.mark.parametrize("fault", [start_pos_off_by_one,
                                   one_routed_event_dropped])
def test_a_broken_keyed_path_is_not_correct(fault, monkeypatch):
    from repro_torch.kernels import ops
    fault(ops, monkeypatch)
    res = tiny_run()
    assert not res["correct"]
    assert res["failed"] >= 1 or res["checks"]["ring_slots_wrong"]["value"]


def test_the_bfloat16_control_is_not_correct():
    """The control entry at the cell's window (3200 events), where counts
    pass bfloat16's exact integers; stated as float64 it computes in
    float32 and is correct, so what fails is the precision."""
    def control(cfg):
        return bench_run.run_cell(
            CELL, SEED, 0.05, False, spec=SPEC, device="cpu",
            entry="control", cfg_override={"lanes": 4, "chunk": 4096, **cfg},
            traffic_override={"uids": 4, "pool_chunks": 6})
    bad = control({})
    assert not bad["correct"]
    assert bad["checks"]["counts_wrong"]["value"] > 0
    assert bad["checks"]["ring_slots_wrong"]["value"] > 0
    good = control({"precision": "float64"})
    assert good["correct"], good["checks"]


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

READERS = ("hit_list_ms", "device_step_host_ms", "counts_copy_ms",
           "lane_route_roofline")
#: the router's and the scan's kernels as the card's profiler names them
PROBE = ("(anonymous namespace)::probe_kernel(unsigned int const*, unsigned "
         "int const*, (anonymous namespace)::Table, int*, unsigned char*, "
         "int, int)")
WALK = "(anonymous namespace)::walk_kernel((anonymous namespace)::Walk)"
SCAN = ("void (anonymous namespace)::fused_scan_kernel<32, false>"
        "((anonymous namespace)::Args, (anonymous namespace)::Specs)")


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def feed_events(t0, route_us=(30, 20), with_spans=True):
    """One keyed feed in microseconds from ``t0``: the router's kernels and
    the scan launched in the device step, the stats and counts copied once
    they end, then the hit list with the device idle."""
    out = [ev("user_annotation", "feed", t0, 10_000),
           ev("kernel", PROBE, t0 + 300, route_us[0]),
           ev("kernel", WALK, t0 + 400, route_us[1]),
           ev("kernel", SCAN, t0 + 500, 6_000),
           ev("gpu_memcpy", "Memcpy DtoH", t0 + 6_600, 300)]
    if with_spans:
        out += [ev("user_annotation", "streaming.device_step", t0 + 100,
                   1_500),
                ev("user_annotation", "partitioned.stats_to_host", t0 + 1_700,
                   4_900),
                ev("user_annotation", "streaming.counts_to_host",
                   t0 + 6_600, 350),
                ev("user_annotation", "streaming.hit_list", t0 + 7_000,
                   2_500)]
    return out


def context(events, bound_s=1e-6):
    tl = Timeline(events)
    return SimpleNamespace(tl=tl, feeds=list(zip(tl.spans["feed"], [7, 8])),
                           bound=lambda name, k: bound_s)


def readers():
    return {m: bench_run.load("metrics", m).read for m in READERS}


def test_readers_on_a_synthetic_timeline():
    ctx = context(feed_events(0) + feed_events(20_000, (40, 10)))
    got = {m: r(ctx) for m, r in readers().items()}
    assert got["hit_list_ms"] == pytest.approx(2.5)
    assert got["device_step_host_ms"] == pytest.approx(1.5)
    # the counts' copy alone, not the wait in the stats span before it
    assert got["counts_copy_ms"] == pytest.approx(0.3)
    # 2 µs of bound over 100 µs of the router's kernels; the scan is not
    # the router
    assert got["lane_route_roofline"] == pytest.approx(2.0)


def test_readers_without_the_programs_spans_or_the_router():
    """The harness's ``feed`` spans and the scan alone, as a program
    without the spans and a run without the card give them: every reader
    returns ``None``."""
    ctx = context([e for e in feed_events(0, with_spans=False)
                   + feed_events(20_000, with_spans=False)
                   if e["name"] not in (PROBE, WALK)])
    assert all(r(ctx) is None for r in readers().values())


def test_lane_route_roofline_is_100_at_its_bound():
    """Router kernels that take exactly the bound of the cell's routing
    (``bench/bounds/lane_route.py`` at 262 144 keys over 2 125 lanes)."""
    traffic = SimpleNamespace(chunk=CFG["chunk"])
    bound = bench_run.load("bounds", "lane_route").seconds(traffic, CFG, 0)
    assert bound == pytest.approx((262144 * 13 + 2125 * 21) / 3.35e12)
    us = 1e6 * bound
    ctx = context(feed_events(0, (us / 2, us / 2))
                  + feed_events(20_000, (us / 4, 3 * us / 4)), bound)
    read = bench_run.load("metrics", "lane_route_roofline").read
    assert read(ctx) == pytest.approx(100.0)


def test_the_router_pattern_names_the_routers_kernels_alone():
    """Every kernel of ``csrc/lane_route.cu`` matches the reader's pattern
    under the names the profiler gives; no kernel of another source
    (``fused_scan_kernel``, ``cea_scan_kernel`` ...) does."""
    pattern = bench_run.load("metrics", "lane_route_roofline").ROUTER
    kernel = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                        r"\s*)?(\w+)\s*\(")
    names = {p.name: kernel.findall(p.read_text())
             for p in sorted(CSRC.glob("*.cu"))}
    assert len(names["lane_route.cu"]) == 6
    for src, found in names.items():
        for k in found:
            for shown in (f"(anonymous namespace)::{k}(int*, int)",
                          f"void (anonymous namespace)::{k}<1>(int const*)"):
                assert bool(pattern.search(shown)) == (
                    src == "lane_route.cu"), shown


def test_a_traced_cpu_run_reports_the_keyed_span_metrics():
    res = tiny_run(trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    for name in ("hit_list_ms", "device_step_host_ms"):
        assert m[name]["unit"] == "ms"
        assert m[name]["value"] > 0
    # no kernel or copy runs on the CPU: the device's metrics are left out
    assert set(m) == {"hit_list_ms", "device_step_host_ms"}
