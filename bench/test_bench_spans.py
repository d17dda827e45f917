"""The readers of the program's ``streaming.*`` spans: on a hand-made
timeline, on one without those spans (what the program gave before it had
them), and through a tiny traced run of ``seq3_pack4.output`` on the CPU."""
from types import SimpleNamespace

import pytest

from bench import run as bench_run
from bench.test_bench_cells import SEED, SPEC, TINY
from bench.timeline import Timeline

READERS = ("hit_list_ms", "device_step_host_ms", "counts_copy_ms")


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def feed_events(t0, with_spans=True):
    """One feed of the cell's shape, in microseconds from ``t0``: the scan
    launched in the device step, the counts copied once it ends, then the
    hit list with the device idle."""
    out = [ev("user_annotation", "feed", t0, 10_000),
           ev("kernel", "fused_scan_kernel<32>", t0 + 300, 4_000),
           ev("gpu_memcpy", "Memcpy DtoH", t0 + 4_400, 500)]
    if with_spans:
        out += [ev("user_annotation", "streaming.device_step", t0 + 100, 400),
                ev("user_annotation", "streaming.counts_to_host",
                   t0 + 600, 4_400),
                ev("user_annotation", "streaming.hit_list", t0 + 5_000,
                   4_800)]
    return out


def readers():
    return {m: bench_run.load("metrics", m).read for m in READERS}


def test_span_readers_on_a_synthetic_timeline():
    tl = Timeline(feed_events(0) + feed_events(20_000) +
                  # a copy elsewhere in the feed is not the counts' copy
                  [ev("gpu_memcpy", "Memcpy HtoD", 20_050, 30)])
    ctx = SimpleNamespace(tl=tl, feeds=list(zip(tl.spans["feed"], [7, 8])))
    read = readers()
    assert read["hit_list_ms"](ctx) == pytest.approx(4.8)
    assert read["device_step_host_ms"](ctx) == pytest.approx(0.4)
    assert read["counts_copy_ms"](ctx) == pytest.approx(0.5)
    # with a third feed whose hit list took twice as long
    tl3 = Timeline(feed_events(0) + feed_events(20_000) + [
        ev("user_annotation", "feed", 40_000, 20_000),
        ev("user_annotation", "streaming.hit_list", 45_000, 9_600)])
    assert read["hit_list_ms"](SimpleNamespace(tl=tl3)) == pytest.approx(
        (4.8 + 4.8 + 9.6) / 3)


def test_span_readers_without_the_programs_spans():
    """The harness's ``feed`` spans alone, as a program without spans
    gives them: every reader returns ``None``; spans without a device
    copy (the CPU) leave ``counts_copy_ms`` out alone."""
    tl = Timeline(feed_events(0, False) + feed_events(20_000, False))
    ctx = SimpleNamespace(tl=tl, feeds=list(zip(tl.spans["feed"], [7, 8])))
    assert all(r(ctx) is None for r in readers().values())
    cpu = Timeline([e for e in feed_events(0) if e["cat"] == "user_annotation"])
    ctx = SimpleNamespace(tl=cpu, feeds=list(zip(cpu.spans["feed"], [7])))
    got = {m: r(ctx) for m, r in readers().items()}
    assert got["counts_copy_ms"] is None
    assert got["hit_list_ms"] == pytest.approx(4.8)


def test_a_traced_cpu_run_reports_the_span_metrics():
    cfg, traffic = TINY["seq3_pack4.output"]
    res = bench_run.run_cell("seq3_pack4.output", SEED, 0.05, True,
                             spec=SPEC, device="cpu", cfg_override=cfg,
                             traffic_override=traffic)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    for name in ("hit_list_ms", "device_step_host_ms"):
        assert m[name]["unit"] == "ms"
        assert m[name]["value"] > 0
    assert "counts_copy_ms" not in m
