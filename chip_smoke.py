#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with a CUDA device, nvcc and
PyTorch built for CUDA.  It builds the port's kernel library from
``src/repro_torch/kernels/csrc/`` (``fused_scan.cu`` and
``arena_update.cu``, one nvcc each, started together), then runs these
phases, each printing one JSON line:

0. card: ``nvidia-smi`` name and power limit, versions, library build time;
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
   ring kept in global memory (D5), and with 26 states (K5): kernel ≡ plain;
5. enumeration at full width: the phase-1 query with the tECS arena
   (``arena_capacity=2**18``, M = 57 738 record slots per event), 64 lanes,
   8 chunks of 256 through both kernels; node store, cells, pointers and
   roots ≡ the plain engine's; lane 0 (rare A1-A3) enumerates what the
   host ``Engine`` finds; sampled hits of the other lanes enumerate their
   count; the arena kernel's time, bound and plain time, the feed's split
   and the enumeration rate;
6. time window and CONSUME with the arena: stock Q1 and Q3 at ring 4096,
   16 lanes; store ≡ plain, lane 0 ≡ host ``Engine``;
7. the other shapes through ``ops.arena_block_update``: LAST with native
   enumeration, K5 (32-state build, K=18), ``n_seg=2``, ragged offsets
   and valid counts with dead lanes: kernel ≡ plain.

Then the kernels line and, last, ``{"ok": true, "device": {...}}``.  Every
comparison of kernel and plain version is exact (tolerance 0): counts are
f32 integers, exact below 2^24 in any order of summation, and the script
checks that every count stays below 2^24; the arena's records, roots and
stores are int32 node ids.  Any failure raises, so the exit
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
    from repro_torch.kernels.build import LIBRARY
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    LIBRARY.get()
    ptxas = [ln.strip() for ln in LIBRARY.build_log.splitlines()
             if ln.startswith("==") or "registers" in ln or "spill" in ln]
    emit({"phase": 0, "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "build_s": round(LIBRARY.build_seconds, 3), "ptxas": ptxas})
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


# ---------------------------------------------------------------------------
# enumeration: the tECS arena and the arena-update kernel
# ---------------------------------------------------------------------------


def ceset(ces) -> set:
    return {(int(c.start), int(c.end), tuple(map(int, c.data)))
            for c in ces}


def host_sets(query: str, stream, *, consume: bool = False) -> dict:
    """position → complex events of the port's host ``Engine`` over one
    lane, under the query's selection strategy."""
    from repro_torch.core import compile_query
    from repro_torch.core.engine import Engine
    from repro_torch.core.selection import apply_strategy
    cq = compile_query(query)
    eng = Engine(cq.cea, window=cq.query.window, consume_on_match=consume)
    out = {}
    for p, ev in enumerate(stream):
        ces = apply_strategy(cq.query.strategy, eng.process(ev))
        if ces:
            out[p] = ceset(ces)
    return out


def check_engines_equal(kern, plain, what: str) -> None:
    """Counting state, node store (below the sink), cells, pointers,
    latches and recorded roots of two arena engines are identical."""
    check(same(kern.state["C"], plain.state["C"]), f"{what}: count state "
          "kernel ≡ plain")
    ka, pa = kern.state["arena"], plain.state["arena"]
    cap = kern.arena_capacity
    for name in ("kind", "pos", "maxs", "left", "right"):
        check(torch.equal(ka[name][:, :cap], pa[name][:, :cap]),
              f"{what}: node store {name} kernel ≡ plain")
    for name in ("cell", "ptr", "ovf"):
        check(torch.equal(ka[name], pa[name]),
              f"{what}: arena {name} kernel ≡ plain")
    check(kern._roots.keys() == plain._roots.keys() and all(
        np.array_equal(kern._roots[k], plain._roots[k])
        for k in kern._roots), f"{what}: roots kernel ≡ plain")


def lane0_check(engine, hits, query, stream, what: str, *,
                consume: bool = False) -> int:
    """Lane 0's enumerated sets equal the host Engine's, position by
    position; returns the number of complex events."""
    got = {p: ceset(v) for (p, _), v in
           engine.enumerate_hits([h for h in hits if h[1] == 0]).items()}
    want = host_sets(query, stream, consume=consume)
    check(got == want, f"{what}: lane 0 enumerates what the host Engine "
          f"finds ({sum(map(len, got.values()))} vs "
          f"{sum(map(len, want.values()))} complex events)")
    return sum(map(len, want.values()))


def host_clock(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_enum(seed: int, B: int = 64, n_chunks: int = 8) -> dict:
    """The phase-1 query with the arena: B=64, ring 3208, M=57 738."""
    from repro_torch.core.events import Event
    from repro_torch.kernels import ops
    from repro_torch.kernels.arena_update import KERNEL as AKERNEL
    from repro_torch.kernels.fused_scan import KERNEL as FKERNEL
    from repro_torch.vector import (StreamingVectorEngine, VectorEngine,
                                    tecs_arena)
    T, eps, cap = 256, 3200, 1 << 18
    query = MAIN_QUERY.format(eps)
    types = ["A1", "A2", "A3"] + [f"B{i}" for i in range(1, 7)]
    ve = VectorEngine(query)
    dev = ve.device
    rng = np.random.default_rng(seed + 5)
    draws = rng.integers(0, len(types), (n_chunks * T, B))
    # lane 0 draws A1-A3 rarely (1 % each), so the host Engine can
    # enumerate every one of its matches
    draws[:, 0] = rng.choice(len(types), n_chunks * T,
                             p=[0.01] * 3 + [0.97 / 6] * 6)
    codes = np.array([ve.encoder.vocab["type"].get(t, -1.0)
                      for t in types],
                     np.float32)
    attrs_all = torch.from_numpy(codes[draws][:, :, None]).to(dev)
    chunks = [attrs_all[i * T:(i + 1) * T] for i in range(n_chunks)]
    kern = StreamingVectorEngine(ve, T, B, arena_capacity=cap)
    plain = StreamingVectorEngine(VectorEngine(query, impl="ref"), T, B,
                                  arena_capacity=cap)

    torch.cuda.synchronize()
    FKERNEL.launches = 0
    AKERNEL.launches = 0
    feed_s, counts_k, hits_k = [], [], []
    for attrs in chunks:
        t0 = time.perf_counter()
        c, h = kern.feed_attrs(attrs)
        feed_s.append(time.perf_counter() - t0)
        counts_k.append(c)
        hits_k += h
    launches = {"fused_scan": FKERNEL.launches,
                "arena_update": AKERNEL.launches}
    check(all(n == n_chunks for n in launches.values()),
          f"phase 5 launched {launches}, expected {n_chunks} of each")
    check(kern.compile_count == 1, f"compile_count {kern.compile_count}")

    # the plain engine, chunk by chunk: one chunk's records live at a time
    counts_p, hits_p = [], []
    for attrs in chunks:
        c, h = plain.feed_attrs(attrs)
        counts_p.append(c)
        hits_p += h
    counts_k, counts_p = np.concatenate(counts_k), np.concatenate(counts_p)
    check(same(counts_k, counts_p) and hits_k == hits_p,
          "phase 5: counts and hits kernel ≡ plain")
    check_engines_equal(kern, plain, "phase 5")
    del plain
    arena = kern.state["arena"]
    check(not bool(arena["ovf"].any()), "phase 5: arena ovf stays clear")
    max_ptr = int(arena["ptr"].max())

    # lane 0 against the host Engine; sampled hits of the other lanes
    lane0 = [Event(types[i], {}, position=p, timestamp=float(p))
             for p, i in enumerate(draws[:, 0])]
    lane0_ces = lane0_check(kern, hits_k, query, lane0, "phase 5")
    sample = [h for h in hits_k if T <= h[0] < 2 * T and h[1] > 0][:32]
    _, s_sync = host_clock(kern.arena_snapshot)
    res, s_enum = host_clock(lambda: kern.enumerate_hits(sample))
    n_ces = 0
    for (p, b), ces in res.items():
        check(len(ces) == counts_k[p, b], f"phase 5: hit {(p, b)} "
              f"enumerates {len(ces)} of {counts_k[p, b]} matches")
        n_ces += len(ces)
    snap = kern.arena_snapshot()
    for b in (0, 1, 2):
        tecs_arena.check_invariants(snap, b)

    # the arena kernel alone, on the next chunk from the saved state
    tb, at = ve.tables, ve.arena_tables()
    lay = tecs_arena._block_layout(at, ve.ring, ve.epsilon, cap)
    kw = dict(lay=lay, ptab=tecs_arena._ptab(at, dev),
              finals_sq=tecs_arena._finals(at, dev))
    start = kern.position % ve.ring
    startv = torch.full((B,), start, dtype=torch.int32, device=dev)
    validv = torch.full((B,), T, dtype=torch.int32, device=dev)
    c_state = clone_state(kern.state["C"])
    ar = {k: v.clone() for k, v in arena.items()}
    (m_f, _, trace), s_count = host_clock(lambda: ops.cer_pipeline(
        chunks[0], ve.encoder.specs, tb.class_of, tb.class_ind, tb.m_all,
        tb.finals[None, :], c_state, init_mask=tb.init_mask,
        window=ve.window, start_pos=start, impl="fused", return_trace=True,
        inplace=True))
    hits = (m_f > 0.5)[..., :1]
    (cells0, sstart0), s_cells = host_clock(
        lambda: tecs_arena.chunk_cells(ar))

    def build(impl):
        return ops.arena_block_update(cells0, trace, hits, startv, validv,
                                      impl=impl, **kw)
    got, s_kernel = host_clock(lambda: build("fused"))
    want = build("ref")
    err = 0.0
    for g, w in zip(got[0] + got[1:], want[0] + want[1:]):
        check(torch.equal(g, w), "phase 5: arena_update kernel ≡ plain on "
              "one chunk")
        err = max(err, max_abs_err(g, w))
    del want
    gpos = (kern.position + torch.arange(T, dtype=torch.int32, device=dev)
            )[:, None].expand(T, B)
    (_, roots), s_store = host_clock(lambda: tecs_arena._arena_translate_store(
        ar, lay, *got, gpos, startv, validv, sstart0, hits))
    del got

    def host_side():
        counts = m_f[:, :, 0].cpu().numpy().astype(np.int64)
        hs = [(kern.position + int(t), int(b))
              for t, b in zip(*np.nonzero(counts))]
        roots_np = roots.cpu().numpy()
        return {h: roots_np[h[0] - kern.position, h[1]] for h in hs}
    recorded, s_host = host_clock(host_side)
    ms = cuda_ms(lambda: build("fused"), reps=3)
    plain_ms = cuda_ms(lambda: build("ref"), reps=1)

    # bound: bytes moved once — records dominate (3·B·T·M·4)
    W, S, K, Q, M = ve.ring, at.num_states, at.max_indegree, 1, lay.M
    rec_bytes = 3 * B * T * M * 4
    nbytes = (rec_bytes + B * T * Q * 4 * 2 + 2 * 4 * B * W * S * 4
              + 4 * T * B * 4 + at.pred_idx.size * 3 * 4)
    # integer work: per live (step, slot, target, edge) a few operations
    ops_n = 8 * T * B * W * S * K
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops_n / PEAK_F32_FLOP_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    feed_med = float(np.median(feed_s))
    result = {
        "phase": 5, "query": query, "B": B, "T": T, "chunks": n_chunks,
        "W": W, "S": S, "K": K, "M": M, "arena_capacity": cap,
        "launches": launches, "compile_count": kern.compile_count,
        "matches": int(counts_k.sum()), "hits": len(hits_k),
        "max_ptr": max_ptr, "lane0_complex_events": lane0_ces,
        "kernel_ms_per_chunk": ms, "plain_ms_per_chunk": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_bytes": nbytes, "record_bytes": rec_bytes,
        "bound_int_ops": ops_n,
        "feed_ms_per_chunk_median": 1e3 * feed_med,
        "feed_ms_per_chunk": [1e3 * x for x in feed_s],
        "events_per_s": B * T / feed_med,
        "feed_steps_ms": {"counting_kernel": 1e3 * s_count,
                          "cell_gather": 1e3 * s_cells,
                          "arena_kernel_with_fill": 1e3 * s_kernel,
                          "translate_and_store": 1e3 * s_store,
                          "host_counts_hits_roots": 1e3 * s_host,
                          "hits": len(recorded)},
        "enum_hits": len(sample), "enum_complex_events": n_ces,
        "enum_first_sync_ms": 1e3 * s_sync, "enum_ms": 1e3 * s_enum,
        "enum_complex_events_per_s": n_ces / s_enum if s_enum else None,
        "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
        "max_abs_err": err}
    emit(result)
    return result


def phase_enum_time(seed: int, B: int = 16, n_chunks: int = 4) -> None:
    """Stock Q1 and Q3 with the arena: ring 4096, M = 106 497."""
    from repro_torch.data import stock_stream
    from repro_torch.vector import (StreamingVectorEngine, VectorEngine,
                                    tecs_arena)
    T, mwe, cap = 256, 4096, 1 << 18
    streams = [stock_stream(T * n_chunks, seed=seed + b,
                            events_per_sec=10.0 if b == 0 else 100.0)
               for b in range(B)]
    for name, query, consume in (("Q1", STOCK_Q1, False),
                                 ("Q3", STOCK_Q3, True)):
        kern = StreamingVectorEngine(
            VectorEngine(query, max_window_events=mwe), T, B,
            arena_capacity=cap)
        plain = StreamingVectorEngine(
            VectorEngine(query, max_window_events=mwe, impl="ref"), T, B,
            arena_capacity=cap)
        hits = []
        for i in range(n_chunks):
            part = [s[i * T:(i + 1) * T] for s in streams]
            ck, hk = kern.feed(part)
            cp, hp = plain.feed(part)
            check(same(ck, cp) and hk == hp,
                  f"phase 6 {name}: counts kernel ≡ plain")
            hits += hk
        check_engines_equal(kern, plain, f"phase 6 {name}")
        del plain
        check(not kern.window_overflow.any(), f"{name}: ovf stays clear")
        ovf = kern.state["arena"]["ovf"]
        check(not bool(ovf[0]), f"phase 6 {name}: lane 0's arena fits")
        n0 = lane0_check(kern, hits, query, streams[0][:T * n_chunks],
                         f"phase 6 {name}", consume=consume)
        lay = tecs_arena._block_layout(kern._arena_tables,
                                       kern.window.ring, kern.epsilon, cap)
        emit({"phase": 6, "query": name, "B": B, "ring": kern.window.ring,
              "S": lay.S, "K": lay.K, "M": lay.M, "chunks": n_chunks,
              "hits": len(hits), "lane0_complex_events": n0,
              "max_ptr": int(kern.state["arena"]["ptr"].max()),
              "arena_ovf_lanes": int(ovf.sum()), "max_abs_err": 0.0})


def random_arena_operands(dev, query, B, T, seed, consume=False):
    """Random builder operands for ``query``'s tables: a sparse
    chunk-start cell table, classes, hits on live steps only, a quarter
    of the lanes at start 0, ragged valid counts and two dead lanes."""
    from repro_torch.vector import VectorEngine, tecs_arena
    ve = VectorEngine(query)
    at = ve.arena_tables()
    cap = 1 << 16
    lay = tecs_arena._block_layout(at, ve.ring, ve.epsilon, cap)
    W, S, Q = lay.W, lay.S, lay.Q
    rng = np.random.default_rng(seed)
    cid = rng.integers(0, cap, (B, W, S)).astype(np.int32)
    cid[rng.random((B, W, S)) < 0.7] = -1
    cells0 = tuple(torch.from_numpy(x).to(dev) for x in (
        cid, rng.integers(0, 2, (B, W, S)).astype(np.int32),
        rng.integers(-1, cap, (B, W, S)).astype(np.int32),
        rng.integers(-1, cap, (B, W, S)).astype(np.int32)))
    start = rng.integers(0, 10 ** 6, B)
    start[: B // 4] = 0
    valid = rng.integers(0, T + 1, B)
    valid[-2:] = 0
    live = np.arange(T)[:, None] < valid[None, :]
    hits = (rng.random((T, B, Q)) < 0.3) & live[:, :, None]
    cls = rng.integers(0, at.pred_idx.shape[0], (T, B)).astype(np.int32)
    kw = dict(lay=lay, ptab=tecs_arena._ptab(at, dev),
              finals_sq=tecs_arena._finals(at, dev))
    if consume:
        kw["consume"] = torch.from_numpy(rng.random((T, B, S)) < 0.05).to(
            dev)
    return (cells0, torch.from_numpy(cls).to(dev),
            torch.from_numpy(hits).to(dev), torch.from_numpy(start).to(dev),
            torch.from_numpy(valid).to(dev)), kw


def phase_enum_shapes(seed: int) -> None:
    """LAST with native enumeration; K5 with n_seg 1 and 2, ragged lanes."""
    from repro_torch.core.events import Event
    from repro_torch.kernels import ops
    from repro_torch.vector import StreamingVectorEngine, VectorEngine
    T, B = 256, 64
    rng = np.random.default_rng(seed + 7)
    ve = VectorEngine(LAST_QUERY)
    kern = StreamingVectorEngine(ve, T, B, arena_capacity=1 << 16)
    plain = StreamingVectorEngine(VectorEngine(LAST_QUERY, impl="ref"), T,
                                  B, arena_capacity=1 << 16)
    types = ["A1", "A2"] + [f"B{i}" for i in range(1, 7)]
    draws = rng.integers(0, len(types), (2 * T, B))
    codes = np.array([ve.encoder.vocab["type"].get(t, -1.0)
                      for t in types],
                     np.float32)
    hits = []
    for i in range(2):
        attrs = torch.from_numpy(codes[draws[i * T:(i + 1) * T]][:, :, None]
                                 ).to(ve.device)
        ck, hk = kern.feed_attrs(attrs)
        cp, hp = plain.feed_attrs(attrs)
        check(same(ck, cp) and hk == hp, "phase 7 LAST: counts kernel ≡ "
              "plain")
        hits += hk
    check_engines_equal(kern, plain, "phase 7 LAST")
    lane0 = [Event(types[i], {}, position=p, timestamp=float(p))
             for p, i in enumerate(draws[:, 0])]
    n0 = lane0_check(kern, hits, LAST_QUERY, lane0, "phase 7 LAST")
    emit({"phase": 7, "case": "LAST native enumeration", "B": B,
          "hits": len(hits), "lane0_complex_events": n0, "max_abs_err": 0.0})

    for n_seg, consume in ((1, True), (2, False)):
        args, kw = random_arena_operands(torch.device("cuda"), K5_QUERY, 32,
                                         T, seed + n_seg, consume=consume)
        got = ops.arena_block_update(*args, n_seg=n_seg, impl="fused", **kw)
        want = ops.arena_block_update(*args, n_seg=n_seg, impl="ref", **kw)
        for g, w in zip(got[0] + got[1:], want[0] + want[1:]):
            check(torch.equal(g, w), f"phase 7 K5 n_seg={n_seg}: "
                  "arena_update kernel ≡ plain")
        lay = kw["lay"]
        emit({"phase": 7, "case": "K5 ragged lanes", "n_seg": n_seg,
              "consume": consume, "B": 32, "T": T, "W": lay.W, "S": lay.S,
              "K": lay.K, "M": lay.M, "fin_states": len(lay.fin_states),
              "records": int(got[1].sum()),
              "roots": int((got[4] >= 0).sum()), "max_abs_err": 0.0})
        del got, want


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
    enum_res = phase_enum(args.seed)
    phase_enum_time(args.seed)
    phase_enum_shapes(args.seed)
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
        "library_ms": None}, {
        "name": "arena_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/arena_update.cu",
        "replaces": "src/repro/kernels/arena_update.py:88",
        "launches": enum_res["launches"]["arena_update"],
        "max_abs_err": enum_res["max_abs_err"],
        "ms": enum_res["kernel_ms_per_chunk"],
        "plain_ms": enum_res["plain_ms_per_chunk"],
        "bound_ms": enum_res["bound_ms"],
        "bound_by": enum_res["bound_by"],
        "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
