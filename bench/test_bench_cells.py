"""Each cell driven end to end on the CPU at a tiny size: the reference
agrees with the port's plain CPU path, and the comparison comes out false
when the timed path is broken underneath (the faults a one-card cell can
have) or when the control (the reference in bfloat16) takes the
program's place.  Besides the cells of ``BENCHMARK.json``, a keyed cell
(``entries/partitioned.py``, ``traffic/keyed.py``) that waits for a
sourced key distribution is defined here, so that its harness stays
proven.  The card test runs each cell briefly at its own size and skips
without a card."""
import json
from types import SimpleNamespace

import pytest
import torch

from bench import run as bench_run
from bench.timeline import Timeline

SPEC = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
#: files of the keyed cell, which has no configuration in the benchmark
KEYED = {
    ("configs", "keyed"): {
        "name": "keyed", "queries": ["A1 ; A2 ; A3"], "window": 3200,
        "query": "SELECT * FROM S WHERE {seq} WITHIN {window} events",
        "precision": "float32", "reference": "seq3", "lanes": 1024,
        "chunk": 262144, "lane_cap": 384, "key_attrs": ["uid"]},
    ("workloads", "keyed.uniform"): {
        "config": "keyed", "entry": "partitioned",
        "bounds": ["fused_scan", "lane_route"],
        "traffic": {"generator": "keyed", "types": [
            "A1", "A2", "A3", "B1", "B2", "B3", "B4", "B5", "B6"],
            "uids": 1024, "null_share": 0.02, "pool_chunks": 48},
        "check": {"sample_share": 0.125}, "trace_seconds": 4},
}
SPEC_ALL = {**SPEC, "workloads": SPEC["workloads"] + [
    {"name": "keyed.uniform", "config": "keyed", "traffic": "uniform",
     "chips": 1, "why": "the keyed harness"}]}
# the cells at a size the CPU runs in well under a second
TINY = {
    "seq3_pack4.output": ({"lanes": 4, "chunk": 32, "window": 40},
                          {"pool_chunks": 5}),
    "keyed.uniform": ({"lanes": 8, "chunk": 128, "window": 40,
                       "lane_cap": 40}, {"pool_chunks": 5, "uids": 8}),
}
SEED = 2 ** 31 + 5


@pytest.fixture(autouse=True)
def keyed_files(monkeypatch):
    load_json = bench_run.load_json
    monkeypatch.setattr(bench_run, "load_json", lambda kind, name: (
        KEYED.get((kind, name)) or load_json(kind, name)))


def tiny_run(name, seed=SEED, trace=False, **kw):
    cfg, traffic = TINY[name]
    return bench_run.run_cell(name, seed, 0.05, trace, spec=SPEC_ALL,
                              device="cpu", cfg_override=cfg,
                              traffic_override=traffic, **kw)


def state_unchanged(orig):
    """The scan returns its counts but leaves the ring as it was."""
    def step(*args, **kw):
        return orig(*args, **{**kw, "inplace": False})
    return step


def half_the_lanes(orig):
    """Only the first half of the lanes is scanned; the rest count 0."""
    def step(attrs, specs, class_of, class_ind, m_all, finals_q, c0, **kw):
        h = attrs.shape[1] // 2
        for key in ("start_pos", "valid_counts"):
            if torch.is_tensor(kw.get(key)) and kw[key].ndim == 1:
                kw[key] = kw[key][:h]
        m, c = orig(attrs[:, :h], specs, class_of, class_ind, m_all,
                    finals_q, c0[:h], **{**kw, "inplace": False})[:2]
        c0[:h].copy_(c)
        out = m.new_zeros((attrs.shape[0], attrs.shape[1], m.shape[2]))
        out[:, :h] = m
        return out, c0
    return step


def one_count_altered(orig):
    """Every scan adds one match at its first event of lane 0."""
    def step(*args, **kw):
        out = orig(*args, **kw)
        out[0][0, 0, 0] += 1
        return out
    return step


FAULTS = {"state_unchanged": state_unchanged,
          "half_the_lanes": half_the_lanes,
          "one_count_altered": one_count_altered}


@pytest.mark.parametrize("name", sorted(TINY))
def test_reference_agrees_with_the_ports_plain_path(name):
    res = tiny_run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert set(res["metrics"]) == {
        m["name"] for m in bench_run.cell_metrics(SPEC_ALL, name,
                                                  "end_to_end")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(TINY))
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "cer_pipeline", FAULTS[fault](ops.cer_pipeline))
    res = tiny_run(name)
    assert not res["correct"]
    assert res["failed"] >= 1 or res["checks"]["ring_slots_wrong"]["value"]


@pytest.mark.parametrize("name,cfg,traffic", [
    ("seq3_pack4.output", {"lanes": 2}, {"pool_chunks": 16}),
    ("keyed.uniform", {"lanes": 4, "chunk": 4096},
     {"uids": 4, "pool_chunks": 6}),
])
def test_the_bfloat16_control_is_not_correct(name, cfg, traffic):
    """The control entry through the harness's own run and comparison,
    at the cell's window (3200 events), where counts pass bfloat16's
    exact integers.  Stated as float64, the same entry computes in
    float32, whose integers are exact at this size: it is correct, so
    what fails is the precision and not the control's assembly."""
    def control(cfg):
        return bench_run.run_cell(name, SEED, 0.05, False, spec=SPEC_ALL,
                                  device="cpu", entry="control",
                                  cfg_override=cfg,
                                  traffic_override=traffic)
    bad = control(cfg)
    assert not bad["correct"]
    assert bad["checks"]["counts_wrong"]["value"] > 0
    assert bad["checks"]["ring_slots_wrong"]["value"] > 0
    good = control({**cfg, "precision": "float64"})
    assert good["correct"], good["checks"]


def test_a_cell_of_data_files_alone(monkeypatch):
    """``seq3_pack4.no_output`` (the paper's no-output stream: no query's
    last type occurs) needs only its workload file: counts stay zero, the
    ring fills, and the run is judged correct."""
    load_json = bench_run.load_json
    cell = dict(load_json("workloads", "seq3_pack4.output"))
    cell["traffic"] = {**cell["traffic"],
                       "types": ["A1", "A2", "B1", "B2", "B4", "B5"]}
    monkeypatch.setattr(bench_run, "load_json", lambda kind, name: (
        cell if (kind, name) == ("workloads", "seq3_pack4.no_output")
        else load_json(kind, name)))
    spec = {**SPEC, "workloads": SPEC["workloads"] + [
        {"name": "seq3_pack4.no_output", "config": "seq3_pack4",
         "traffic": "no_output", "chips": 1, "why": "control"}]}
    res = bench_run.run_cell("seq3_pack4.no_output", SEED, 0.05, False,
                             spec=spec, device="cpu",
                             cfg_override=TINY["seq3_pack4.output"][0],
                             traffic_override={"pool_chunks": 5})
    assert res["correct"], res["checks"]


def test_trace_reduction_on_a_synthetic_timeline():
    us = 1e6
    ev = [{"ph": "X", "cat": "user_annotation", "name": "feed",
           "ts": 0, "dur": 10_000},
          {"ph": "X", "cat": "user_annotation", "name": "feed",
           "ts": 20_000, "dur": 10_000},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
           "ts": 11_000, "dur": 4_000},
          {"ph": "X", "cat": "kernel", "name": "fused_scan_kernel<32>",
           "ts": 1_000, "dur": 4_000},
          {"ph": "X", "cat": "kernel", "name": "probe_kernel",
           "ts": 21_000, "dur": 1_000},
          {"ph": "X", "cat": "kernel", "name": "fused_scan_kernel<32>",
           "ts": 22_000, "dur": 4_000},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
           "ts": 26_000, "dur": 1_000}]
    tl = Timeline(ev)
    feeds = list(zip(tl.spans["feed"], [7, 8]))
    ctx = SimpleNamespace(tl=tl, feeds=feeds, cell={"bounds": ["scan"]},
                          bound=lambda name, k: 0.001)
    read = {m: bench_run.load("metrics", m).read for m in (
        "feed_host_ms", "route_device_ms", "fused_scan_roofline",
        "idle_share", "feed_mfu")}
    assert read["feed_host_ms"](ctx) == pytest.approx((6 + 4) / 2)
    assert read["route_device_ms"](ctx) == pytest.approx(0.5)
    assert read["fused_scan_roofline"](ctx) == pytest.approx(25.0)
    assert read["idle_share"](ctx) == pytest.approx(100 * (1 - 10 / 30))
    assert read["feed_mfu"](ctx) == pytest.approx(10.0)
    br = tl.breakdown(0, 30_000 / us, ("feed",))
    assert br["device_ops"][0] == ["fused_scan_kernel<32>",
                                   pytest.approx(0.008)]
    assert br["idle_gaps"][0] == ["between feeds: aten::copy_",
                                  pytest.approx(0.016)]
    assert br["idle_gaps"][1] == ["feed: host", pytest.approx(0.003)]


@pytest.mark.parametrize("name", sorted(TINY))
def test_scan_bound_counts_the_programs_nonzeros(name):
    """The bound's operations, counted from the traffic, equal those the
    port's own tables give (``chip_smoke.py``'s method) at a tiny size."""
    from repro_torch.kernels import ref
    cfg = {**bench_run.load_json("configs",
                                 bench_run.load_json("workloads", name)
                                 ["config"]), **TINY[name][0]}
    cell = bench_run.load_json("workloads", name)
    traffic = bench_run.load("traffic", cell["traffic"]["generator"]).Traffic(
        {**cell["traffic"], **TINY[name][1]}, cfg, SEED, "cpu")
    entry = bench_run.load("entries", cell["entry"]).Entry(cfg, traffic,
                                                            "cpu")
    entry.make_pool()
    flops, _ = bench_run.load("bounds", "fused_scan").work(traffic, cfg, 3)
    eng = entry.engine.engine
    t = eng.tables
    attrs = entry.pool[3] if traffic.layout == "lanes" else \
        entry.pool[3][0][(traffic.keys[3] >= 0)][:, None]
    specs = eng.encoder.specs
    cls = ref.class_trace_ref(
        attrs, torch.tensor([s[0] for s in specs]),
        torch.tensor([s[1] for s in specs]),
        torch.tensor([s[2] for s in specs]), t.class_of)
    nnz = (t.m_all != 0).sum(dim=(1, 2))
    want = 2 * (cfg["window"] + 1) * (int(nnz[cls.long()].sum())
                                      + cls.numel() * int((t.finals != 0)
                                                          .sum()))
    assert flops == want


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TINY))
def test_each_cell_runs_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels are CUDA C++ "
                    "and have no CPU mode")
    res = bench_run.run_cell(name, SEED, 2.0, False, spec=SPEC_ALL)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
