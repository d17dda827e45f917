#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with a CUDA device, nvcc and
PyTorch built for CUDA.  It builds the fused-scan kernel from
``src/repro_torch/kernels/csrc/fused_scan.cu``, then runs these phases,
each printing one JSON line:

0. card: ``nvidia-smi`` name and power limit, versions, kernel build time;
1. main path at full width: ``A1 ; A2 ; A3 WITHIN 3200 events`` (ring
   3208), 1024 lanes, 8 chunks of 256 through
   ``StreamingVectorEngine.feed_attrs``; kernel ≡ plain version and a
   closed-form count on a few lanes; times and the bound;
2. encoder and host oracle: the same query ``WITHIN 100 events`` fed as
   Events through ``feed``; counts equal the host ``Engine``'s;
3. time window and CONSUME: stock Q1 and Q3 (``WITHIN 30000
   [stock_time]``), ring 4096, 64 lanes; kernel ≡ plain, host agreement on
   lane 0 (which trades slower, so the host can enumerate its matches),
   ``ovf`` clear;
4. LAST; per-lane offsets, valid counts and the trace with CONSUME on a
   ring kept in global memory (D5), and with 26 states (K5): kernel ≡ plain.

Then the kernels line and, last, ``{"ok": true, "device": {...}}``.  Every
comparison of kernel and plain version is exact (tolerance 0): counts are
f32 integers, exact below 2^24 in any order of summation, and the script
checks that every count stays below 2^24.  Any failure raises, so the exit
code is not 0 and no result line is printed.  Without CUDA, or outside a
checkout, it exits with an error before doing anything.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM bandwidth and f32 (non-tensor) peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
EXACT_LIMIT = 2 ** 24
MAIN_QUERY = "SELECT * FROM S WHERE A1 ; A2 ; A3 WITHIN {} events"
STOCK_Q1 = """SELECT * FROM S
    WHERE SELL AS msft ; BUY AS oracle ; BUY AS csco ; SELL AS amat
    FILTER msft[name = 'MSFT'] AND oracle[name = 'ORCL'] AND
    csco[name = 'CSCO'] AND amat[name = 'AMAT']
    WITHIN 30000 [stock_time]"""
STOCK_Q3 = STOCK_Q1 + "\n    CONSUME BY ANY"
LAST_QUERY = "SELECT LAST * FROM S WHERE A1 ; A2 WITHIN 63 events"
D5_CONSUME = ("SELECT * FROM S WHERE A1 ; (A2 OR A2') ; A3 ; (A4 OR A4') "
              "; A5 WITHIN 4000 events CONSUME BY ANY")
K5_QUERY = "SELECT * FROM S WHERE A1 ; A2+ ; A3 ; A4+ ; A5 WITHIN 100 events"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def same(a, b) -> bool:
    """Exact equality of tensors, arrays or state dicts."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return np.array_equal(np.asarray(a), np.asarray(b))


def max_abs_err(a, b) -> float:
    if isinstance(a, dict):
        return max(max_abs_err(a[k], b[k]) for k in a)
    a = torch.as_tensor(a).double()
    b = torch.as_tensor(b).double().to(a.device)
    return float((a - b).abs().max()) if a.numel() else 0.0


def type_attrs(encoder, rng, T: int, B: int, types, device) -> torch.Tensor:
    """(T, B, 1) encoded ``type`` column: uniform over ``types``."""
    codes = np.array([encoder.vocab["type"].get(t, -1.0) for t in types],
                     np.float32)
    draw = rng.integers(0, len(types), size=(T, B))
    return torch.from_numpy(codes[draw][:, :, None]).to(device)


def seq3_counts(types_tb: np.ndarray, eps: int) -> np.ndarray:
    """Closed-form counts of ``A1 ; A2 ; A3 WITHIN eps events`` (ALL):
    at each A3 position j, the pairs i1 < i2 < j with A1 at i1, A2 at i2
    and j - i1 ≤ eps.  ``types_tb`` holds 0/1/2 for A1/A2/A3, -1 noise."""
    T, B = types_tb.shape
    out = np.zeros((T, B), np.int64)
    for b in range(B):
        col = types_tb[:, b]
        pre_a1 = np.concatenate([[0], np.cumsum(col == 0)])   # A1 in [0, x)
        a2 = np.nonzero(col == 1)[0]
        for j in np.nonzero(col == 2)[0]:
            lo = max(0, j - eps)
            i2 = a2[(a2 >= lo) & (a2 < j)]
            out[j, b] = int((pre_a1[i2] - pre_a1[lo]).sum())
    return out


def host_counts(query: str, stream, *, consume: bool = False):
    """Per-position counts of the port's host ``Engine`` over one lane."""
    from repro_torch.core import compile_query
    from repro_torch.core.engine import Engine
    compiled = compile_query(query)
    eng = Engine(compiled.cea, window=compiled.query.window,
                 consume_on_match=consume)
    return np.array([len(eng.process(ev)) for ev in stream], np.int64)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def clone_state(state):
    if isinstance(state, dict):
        return {k: v.clone() for k, v in state.items()}
    return state.clone()


# ---------------------------------------------------------------------------


def phase_card() -> str:
    from repro_torch.kernels.fused_scan import KERNEL
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    KERNEL.library()
    ptxas = [ln.strip() for ln in KERNEL.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": 0, "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "build_s": round(KERNEL.build_seconds, 3), "ptxas": ptxas})
    return smi


def phase_main(seed: int, B: int = 1024, n_chunks: int = 8) -> dict:
    """Full width: B=1024, ring 3208, S=7, 8 chunks of 256."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_scan import KERNEL
    from repro_torch.vector import StreamingVectorEngine, VectorEngine
    T, eps = 256, 3200
    types = ["A1", "A2", "A3"] + [f"B{i}" for i in range(1, 7)]
    ve = VectorEngine(MAIN_QUERY.format(eps))
    tab = ve.tables
    check(ve.ring == 3208 and tab.num_states == 7 and tab.num_classes == 8
          and tab.num_bits == 3, "main query tables are ring 3208, S=7, "
          "C=8, k=3")
    rng = np.random.default_rng(seed)
    chunks = [type_attrs(ve.encoder, rng, T, B, types, ve.device)
              for _ in range(n_chunks)]
    kern = StreamingVectorEngine(ve, T, B)
    plain = StreamingVectorEngine(VectorEngine(MAIN_QUERY.format(eps),
                                               impl="ref"), T, B)

    torch.cuda.synchronize()
    KERNEL.launches = 0
    feed_s, counts_k, hits_k = [], [], []
    for attrs in chunks:
        t0 = time.perf_counter()
        c, h = kern.feed_attrs(attrs)
        feed_s.append(time.perf_counter() - t0)
        counts_k.append(c)
        hits_k += h
    launches = KERNEL.launches
    check(launches == n_chunks, f"main path launched the kernel "
          f"{launches} times, expected {n_chunks}")
    check(kern.compile_count == 1, f"compile_count {kern.compile_count}")

    counts_p, hits_p = [], []
    for attrs in chunks:
        c, h = plain.feed_attrs(attrs)
        counts_p.append(c)
        hits_p += h
    counts_k, counts_p = np.concatenate(counts_k), np.concatenate(counts_p)
    check(same(counts_k, counts_p), "main counts: kernel ≡ plain")
    check(hits_k == hits_p, "main hits: kernel ≡ plain")
    check(same(kern.state, plain.state), "main ring: kernel ≡ plain")
    err = max(max_abs_err(counts_k, counts_p),
              max_abs_err(kern.state, plain.state))
    check(counts_k.max() < EXACT_LIMIT and
          float(kern.state.max()) < EXACT_LIMIT, "counts stay below 2^24")
    # an independent reference: the closed-form count on 8 lanes
    codes = torch.cat(chunks)[:, :8, 0].cpu().numpy().astype(np.int64)
    check(same(seq3_counts(codes, eps), counts_k[:, :8]),
          "main counts equal the closed-form count on 8 lanes")

    # kernel and plain version timed on one chunk from the final state
    attrs = chunks[0]
    t = tab
    kw = dict(init_mask=t.init_mask, window=ve.window, start_pos=0,
              latest_q=t.latest_q, consume_sq=t.consume_sq, inplace=True)
    st_k, st_p = clone_state(kern.state), clone_state(kern.state)

    def run(impl, st):
        return lambda: ops.cer_pipeline(
            attrs, ve.encoder.specs, t.class_of, t.class_ind, t.m_all,
            t.finals[None, :], st, impl=impl, **kw)
    ms = cuda_ms(run("fused", st_k), reps=5)
    plain_ms = cuda_ms(run("ref", st_p), reps=2)

    # where a feed's time goes: the steps of feed_attrs one at a time
    def host_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    counts_f, s_launch = host_s(lambda: run("fused", st_k)()[0])
    counts, s_copy = host_s(
        lambda: counts_f[:, :, 0].cpu().numpy().astype(np.int64))
    hits, s_hits = host_s(lambda: [(int(t), int(b)) for t, b in
                                   zip(*np.nonzero(counts))])

    # bound: bytes moved once, and the sparse arithmetic this data needs
    W, S, NQ, A = ve.ring, t.num_states, 1, attrs.shape[2]
    idx = torch.tensor([s[0] for s in ve.encoder.specs], device=ve.device)
    opc = torch.tensor([s[1] for s in ve.encoder.specs], device=ve.device)
    thr = torch.tensor([s[2] for s in ve.encoder.specs], device=ve.device)
    cls = ref.class_trace_ref(attrs, idx, opc, thr, t.class_of)
    nnz_m = (t.m_all != 0).sum(dim=(1, 2))                   # per class
    mac = W * (int(nnz_m[cls.long()].sum())
               + T * B * int((t.finals != 0).sum()))
    flops = 2 * mac
    nbytes = 4 * (2 * B * W * S + T * B * A + T * B * NQ + 2 * B
                  + t.m_all.numel() + t.class_of.numel() + 2 * S)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    feed_med = float(np.median(feed_s))
    result = {"phase": 1, "query": MAIN_QUERY.format(eps), "B": B, "T": T,
              "chunks": n_chunks, "W": W, "S": S,
              "C": t.num_classes, "k": t.num_bits,
              "state_MB": B * W * S * 4 / 1e6,
              "launches": launches, "compile_count": kern.compile_count,
              "matches": int(counts_k.sum()), "hits": len(hits_k),
              "max_count": int(counts_k.max()),
              "kernel_ms_per_chunk": ms, "plain_ms_per_chunk": plain_ms,
              "feed_ms_per_chunk_median": 1e3 * feed_med,
              "feed_ms_per_chunk": [1e3 * s for s in feed_s],
              "events_per_s": B * T / feed_med,
              "feed_steps_ms": {"kernel_launch_and_wait": 1e3 * s_launch,
                                "counts_to_host": 1e3 * s_copy,
                                "hit_list": 1e3 * s_hits,
                                "hits": len(hits)},
              "kernel_events_per_s": B * T / (ms / 1e3),
              "bound_ms": bound_ms,
              "bound_by": "bytes" if t_bytes >= t_ops else "operations",
              "bound_bytes": nbytes, "bound_flops": flops,
              "max_abs_err": err}
    emit(result)
    return result


def phase_host(seed: int) -> None:
    """Events through feed(); counts equal the host Engine's."""
    from repro_torch.data import StreamSpec, random_stream
    from repro_torch.vector import StreamingVectorEngine, VectorEngine
    B, T, n_chunks = 4, 256, 4
    query = MAIN_QUERY.format(100)
    streams = [random_stream(StreamSpec(["A1", "A2", "A3"], seed=seed + b),
                             T * n_chunks) for b in range(B)]
    kern = StreamingVectorEngine(VectorEngine(query), T, B)
    plain = StreamingVectorEngine(VectorEngine(query, impl="ref"), T, B)
    got_k, got_p = [], []
    for i in range(n_chunks):
        part = [s[i * T:(i + 1) * T] for s in streams]
        got_k.append(kern.feed(part)[0])
        got_p.append(plain.feed(part)[0])
    got_k, got_p = np.concatenate(got_k), np.concatenate(got_p)
    want = np.stack([host_counts(query, s) for s in streams], axis=1)
    check(same(got_k, got_p) and same(kern.state, plain.state),
          "phase 2: kernel ≡ plain")
    check(same(got_k, want), "phase 2: counts equal the host Engine's")
    emit({"phase": 2, "query": query, "B": B, "events": T * n_chunks,
          "matches": int(got_k.sum()), "host_matches": int(want.sum()),
          "max_abs_err": max_abs_err(got_k, got_p)})


def phase_time(seed: int, B: int = 64, n_chunks: int = 16) -> None:
    """Stock Q1 and Q3: time window, ring 4096, CONSUME BY ANY."""
    from repro_torch.data import stock_stream
    from repro_torch.vector import StreamingVectorEngine, VectorEngine
    T, mwe = 256, 4096
    # lane 0 trades at 10 events/s (a window of about 300 events) so that
    # the host Engine, which enumerates every match, can check it; the
    # other lanes at 100 events/s hold about 3000 live starts of 4096
    streams = [stock_stream(T * n_chunks, seed=seed + b,
                            events_per_sec=10.0 if b == 0 else 100.0)
               for b in range(B)]
    for name, query, consume in (("Q1", STOCK_Q1, False),
                                 ("Q3", STOCK_Q3, True)):
        kern = StreamingVectorEngine(
            VectorEngine(query, max_window_events=mwe), T, B)
        plain = StreamingVectorEngine(
            VectorEngine(query, max_window_events=mwe, impl="ref"), T, B)
        got_k, got_p = [], []
        for i in range(n_chunks):
            part = [s[i * T:(i + 1) * T] for s in streams]
            got_k.append(kern.feed(part)[0])
            got_p.append(plain.feed(part)[0])
        got_k, got_p = np.concatenate(got_k), np.concatenate(got_p)
        check(same(got_k, got_p), f"{name}: counts kernel ≡ plain")
        check(same(kern.state, plain.state),
              f"{name}: ring, ts ring and ovf kernel ≡ plain")
        check(not kern.window_overflow.any(), f"{name}: ovf stays clear")
        want = host_counts(query, streams[0], consume=consume)
        check(same(got_k[:, 0], want), f"{name}: lane 0 equals the host "
              "Engine")
        emit({"phase": 3, "query": name, "B": B, "ring": kern.window.ring,
              "S": kern.engine.tables.num_states,
              "events_per_lane": T * n_chunks,
              "matches": int(got_k.sum()), "lane0_matches": int(want.sum()),
              "max_count": int(got_k.max()),
              "max_abs_err": max(max_abs_err(got_k, got_p),
                                 max_abs_err(kern.state, plain.state))})


def phase_last_lanes(seed: int, B: int = 256) -> None:
    """LAST through the streaming engine; per-lane offsets, valid counts
    and the trace through cer_pipeline, on a ring kept in global memory."""
    from repro_torch.kernels import ops
    from repro_torch.vector import StreamingVectorEngine, VectorEngine
    rng = np.random.default_rng(seed + 4)
    T = 256
    ve = VectorEngine(LAST_QUERY)
    kern = StreamingVectorEngine(ve, T, B)
    plain = StreamingVectorEngine(VectorEngine(LAST_QUERY, impl="ref"), T, B)
    types = ["A1", "A2"] + [f"B{i}" for i in range(1, 7)]
    errs = []
    for _ in range(2):
        attrs = type_attrs(ve.encoder, rng, T, B, types, ve.device)
        ck, hk = kern.feed_attrs(attrs)
        cp, hp = plain.feed_attrs(attrs)
        check(same(ck, cp) and hk == hp, "LAST: counts kernel ≡ plain")
        errs.append(max_abs_err(ck, cp))
    check(same(kern.state, plain.state), "LAST: ring kernel ≡ plain")
    emit({"phase": 4, "case": "LAST", "query": LAST_QUERY, "B": B,
          "matches": int(ck.sum()), "max_abs_err": max(errs)})

    # per-lane offsets (some at 0, so early expire indices are negative),
    # ragged valid counts and the trace; D5's ring (W·S·4 = 240 KB a lane)
    # exceeds shared memory and stays in global memory, K5 takes the
    # 32-state build
    for query, sparse_c0 in ((D5_CONSUME, True), (K5_QUERY, False)):
        ve = VectorEngine(query)
        t = ve.tables
        types = ([f"A{i}" for i in range(1, 6)] + ["A2'", "A4'"]
                 + [f"B{i}" for i in range(1, 7)])
        attrs = type_attrs(ve.encoder, rng, T, B, types, ve.device)
        c0 = ve.init_state(B)
        if sparse_c0:
            c0.copy_(torch.from_numpy(
                (rng.random(c0.shape) < 0.01).astype(np.float32)))
            c0[:, :, 0] = 0.0
        start = rng.integers(0, 10 ** 6, B)
        start[: B // 4] = 0
        start = torch.from_numpy(start).to(ve.device)
        valid = torch.from_numpy(rng.integers(0, T + 1, B)).to(ve.device)
        args = (attrs, ve.encoder.specs, t.class_of, t.class_ind, t.m_all,
                t.finals[None, :])
        kw = dict(init_mask=t.init_mask, window=ve.window, start_pos=start,
                  valid_counts=valid, return_trace=True,
                  latest_q=t.latest_q, consume_sq=t.consume_sq)
        got = ops.cer_pipeline(*args, c0, impl="fused", **kw)
        want = ops.cer_pipeline(*args, c0, impl="ref", **kw)
        for g, w, what in zip(got, want, ("counts", "ring", "trace")):
            check(same(g, w), f"per-lane {query}: {what} kernel ≡ plain")
        check(float(got[0].max()) < EXACT_LIMIT and
              float(got[1].max()) < EXACT_LIMIT,
              f"per-lane {query}: counts stay below 2^24")
        emit({"phase": 4, "case": "per-lane offsets and trace",
              "query": query, "B": B, "W": ve.ring, "S": t.num_states,
              "C": t.num_classes,
              "ring_bytes_per_lane": ve.ring * t.num_states * 4,
              "matches": int(got[0].sum()),
              "max_abs_err": max(max_abs_err(g, w)
                                 for g, w in zip(got, want))})


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit("chip_smoke.py runs from a checkout of the repository: "
                 "src/repro_torch is missing")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_card()
    main_res = phase_main(args.seed)
    phase_host(args.seed)
    phase_time(args.seed)
    phase_last_lanes(args.seed)
    emit({"kernels": [{
        "name": "fused_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_scan.cu",
        "replaces": "src/repro/kernels/fused_scan.py:215",
        "launches": main_res["launches"],
        "max_abs_err": main_res["max_abs_err"],
        "max_abs_diff": main_res["max_abs_err"],
        "ms": main_res["kernel_ms_per_chunk"],
        "plain_ms": main_res["plain_ms_per_chunk"],
        "bound_ms": main_res["bound_ms"],
        "bound_by": main_res["bound_by"],
        "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
