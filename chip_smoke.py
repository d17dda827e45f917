#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with a CUDA device, nvcc and
PyTorch built for CUDA.  It builds the port's kernel library from
``src/repro_torch/kernels/csrc/`` (``fused_scan.cu``, ``arena_update.cu``,
``bitvector.cu`` and ``cea_scan.cu``, one nvcc each, started together),
then runs these phases, each printing one JSON line:

0. card: ``nvidia-smi`` name and power limit, versions, library build time;
1. main path at full width: ``A1 ; A2 ; A3 WITHIN 3200 events`` (ring
   3208), 1024 lanes, 8 chunks of 256 through
   ``StreamingVectorEngine.feed_attrs``, the ring whole in one block's
   shared memory (``n_split`` 1); kernel ≡ plain version and a
   closed-form count on a few lanes; times and the bound, and the time of
   a forced split over two blocks per lane, which must equal it;
2. encoder and host oracle: the same query ``WITHIN 100 events`` fed as
   Events through ``feed``; counts equal the host ``Engine``'s;
3. time window and CONSUME: stock Q1 and Q3 (``WITHIN 30000
   [stock_time]``), ring 4096, 64 lanes; kernel ≡ plain, host agreement on
   lane 0 (which trades slower, so the host can enumerate its matches),
   ``ovf`` clear;
4. LAST; per-lane offsets, valid counts and the trace with CONSUME on a
   ring kept in global memory by one block (D5), and with 26 states (K5):
   kernel ≡ plain;
5. enumeration: the phase-1 query with the tECS arena
   (``arena_capacity=2**18``, M = 57 738 layout slots per event), 64 lanes,
   8 chunks of 256 through the fused-scan kernel and the arena_update
   store kernel (one launch each per chunk, no dense launch); node store,
   cells, pointers and roots ≡ the plain engine's; lane 0 (rare A1-A3)
   enumerates what the host ``Engine`` finds; sampled hits of the other
   lanes enumerate their count; on one more chunk the store kernel ≡ its
   plain version, and the old route (dense records with their fill, then
   the chunk-level translation) ≡ the store kernel; the store kernel's
   time, bound (from the nodes it allocates) and plain time, the old
   route's times and bound, the feed's split, peak memory and the
   enumeration rate;
6. time window and CONSUME with the arena: stock Q1 and Q3 at ring 4096,
   16 lanes; store ≡ plain, lane 0 ≡ host ``Engine``;
7. the other shapes through ``ops.arena_block_update``: LAST with native
   enumeration, K5 (32-state build, K=18), ``n_seg=2``, ragged offsets
   and valid counts with dead lanes: kernel ≡ plain;
8. the unfused path at phase 1's configuration: ``StreamingVectorEngine(
   impl="unfused")`` (bitvector + cea_scan_multi) and ``classify`` +
   ``scan`` (bitvector + cea_scan) ≡ phase 1's fused run and the closed
   form; each kernel's time, bound and plain time;
9. the packed ``MultiQueryEngine``: four standing queries of the Fig. 8
   shape (Ŝ = 28, k = 9, 512 joint classes, ring 3208, 372 KB a lane,
   368 MB in all), 1024 lanes, 8 chunks through ``impl="fused"`` and
   ``"unfused"`` (each kernel's ring split over ``n_split`` ≥ 2 blocks
   per lane in shared memory) and the plain version; each query ≡ its
   closed form on 8 lanes; both kernels' ``n_split`` and times, with
   forced splits (fused 2, 4, 8; cea_scan_multi 2, 4), each ≡ plain; then
   the packed tECS arena at a window of 300 events, 16 lanes: store ≡
   plain, lane 0 ≡ the host ``Engine`` per query;
10. edge shapes of the kernels against their plain versions (state
    buckets, the wide build past 32 states, query groups past 8, rings of
    exactly ε+1, start 0 and a chunked carry, NaN attributes; forced
    splits of all three scans at those shapes, trimmed splits, time
    windows; a pack padded to 512 states and 16 query slots), scans past
    32 states and 8 queries and the unfused calls the scan kernels do not
    take (≡ plain, the unfused ones ≡ ``impl="fused"`` with one fused
    launch) and the routers' refusals;
11. nine standing queries of the Fig. 8 shape (Ŝ = 63, NQ = 9, k = 9,
    ring 3208, 828 MB), 1024 lanes, 8 chunks through the fused and the
    unfused feed (the wide build, split over blocks), plain on the last
    chunk; each query ≡ its closed form on 8 lanes; kernel times and
    bound, feed times, both ``n_split``; then the nine-query arena at a
    window of 300 events, 16 lanes (Q = 9, S = 63);
12. enumeration at phase 1's width: phase 5's query and draws at 1024
    lanes (5.4 GB node store), 8 chunks through the store kernel; 64 lanes
    spread over the 1024 (lane 0 among them) ≡ a plain engine fed their
    columns, counts and hits ≡ an engine without the arena, lane 0 ≡ the
    host ``Engine``; feed time and events/s, the store kernel's time and
    bound on one more chunk (≡ plain), peak memory, sampled enumeration.

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
# the packed engine's four standing queries (phase 9): the paper's Fig. 8
# shape over A1-A3 and B1-B6
PACKED_QUERY = "SELECT * FROM S WHERE {} WITHIN {} events"
PACKED_SEQS = ("A1 ; A2 ; A3", "B1 ; B2 ; B3", "B4 ; B5 ; B6",
               "A1 ; B5 ; A3")
# phase 11: nine standing queries of the same shape (Ŝ = 63, NQ = 9)
NINE_SEQS = PACKED_SEQS + ("A2 ; B1 ; B6", "B2 ; A3 ; B4", "B3 ; B6 ; A1",
                           "A3 ; A1 ; B2", "B5 ; B4 ; A2")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def same(a, b) -> bool:
    """Exact equality of tensors, arrays or state dicts."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
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


def phase_main(seed: int, B: int = 1024, n_chunks: int = 8):
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
    plan = KERNEL.last_plan
    check(plan == (True, 1), f"phase 1's ring (90 KB a lane) stays whole "
          f"in one block's shared memory, got plan {plan}")

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

    def run(impl, st, split=None):
        return lambda: ops.cer_pipeline(
            attrs, ve.encoder.specs, t.class_of, t.class_ind, t.m_all,
            t.finals[None, :], st, impl=impl, split=split, **kw)
    # a forced split of two blocks per lane (45 KB each) ≡ one block
    one = run("fused", clone_state(kern.state))()
    two = run("fused", clone_state(kern.state), split=2)()
    check(KERNEL.last_plan == (True, 2), f"forced split=2 ran "
          f"{KERNEL.last_plan}")
    check(same(one[0], two[0]) and same(one[1], two[1]),
          "phase 1: split=2 ≡ n_split=1 (counts and ring)")
    del one, two
    ms = cuda_ms(run("fused", st_k), reps=5)
    split2_ms = cuda_ms(run("fused", clone_state(kern.state), split=2),
                        reps=5)
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
              "use_smem": plan[0], "n_split": plan[1],
              "matches": int(counts_k.sum()), "hits": len(hits_k),
              "max_count": int(counts_k.max()),
              "kernel_ms_per_chunk": ms, "plain_ms_per_chunk": plain_ms,
              "kernel_ms_per_chunk_split2": split2_ms,
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
    # what phase 8 holds the unfused path against
    run = {"chunks": chunks, "counts": counts_k, "hits": hits_k,
           "ring": kern.state}
    return result, run


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
    from repro_torch.kernels.fused_scan import KERNEL as FKERNEL
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
        plan = FKERNEL.last_plan
        check(plan == ((False, 1) if sparse_c0 else (True, 1)),
              f"per-lane {query}: ring plan {plan} (D5 CONSUME: one block, "
              "global memory; K5: one block, shared memory)")
        want = ops.cer_pipeline(*args, c0, impl="ref", **kw)
        for g, w, what in zip(got, want, ("counts", "ring", "trace")):
            check(same(g, w), f"per-lane {query}: {what} kernel ≡ plain")
        check(float(got[0].max()) < EXACT_LIMIT and
              float(got[1].max()) < EXACT_LIMIT,
              f"per-lane {query}: counts stay below 2^24")
        emit({"phase": 4, "case": "per-lane offsets and trace",
              "query": query, "B": B, "W": ve.ring, "S": t.num_states,
              "C": t.num_classes, "use_smem": plan[0], "n_split": plan[1],
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


def timed_ms(setup, fn, reps: int) -> float:
    """Mean device time of ``fn(*setup())`` over ``reps`` calls after one
    warm-up; ``setup`` (restoring the state ``fn`` updates in place) runs
    outside the timed window."""
    total = 0.0
    for i in range(reps + 1):
        args = setup()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn(*args)
        t1.record()
        torch.cuda.synchronize()
        if i:
            total += t0.elapsed_time(t1)
    return total / reps


def arena_bound(nodes, B, T, W, S, K, Q, folded):
    """Least time of one store-route chunk from what its inputs need: the
    nodes allocated (5 int32 fields each), the (id, is-union, left, right)
    cell table read and written once, the step operands (class, hits,
    position, start/valid, roots) and the slot starts; integer work of
    about 8 operations per folded (step, slot, state, predecessor edge),
    twice (count and emit pass), at the f32 non-tensor rate.  Returns
    (ms, "bytes"|"operations", bytes, ops)."""
    nbytes = (20 * nodes + 2 * 4 * B * W * S * 4 + 4 * T * B * (4 + 2 * Q)
              + 4 * B * W)
    ops_n = 2 * 8 * folded * S * K
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops_n / PEAK_F32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops_n)


def folded_slot_steps(cell0, cell1, T):
    """Folded (step, slot) pairs of one chunk, estimated from the data: the
    occupied ring slots at the chunk's start and end, averaged, plus the
    seeded slot of each step."""
    occ = [int((c != -1).any(dim=2).sum()) for c in (cell0, cell1)]
    return T * (sum(occ) / 2 + cell0.shape[0])


def arena_chunk(kern, ve, chunk, B, T, cap, what, dense=False):
    """One more chunk of a store-route engine, from its saved state: the
    counting kernel, the cell gather and the store kernel timed one at a
    time (host clock), the store kernel ≡ its plain version (node store,
    cells, pointers, latches, roots), the kernel alone timed on the card
    and its bound; ``dense`` also runs and times the old route (dense
    records with their fill, then the chunk-level translation) and holds
    it against the store kernel."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.arena_update import KERNEL as AKERNEL
    from repro_torch.kernels import ref
    from repro_torch.vector import tecs_arena
    dev = ve.device
    tb, at = ve.tables, ve.arena_tables()
    lay = tecs_arena._block_layout(at, ve.ring, ve.epsilon, cap)
    kw = dict(lay=lay, ptab=tecs_arena._ptab(at, dev),
              finals_sq=tecs_arena._finals(at, dev))
    start = kern.position % ve.ring
    startv = torch.full((B,), start, dtype=torch.int32, device=dev)
    validv = torch.full((B,), T, dtype=torch.int32, device=dev)
    gpos = (kern.position + torch.arange(T, dtype=torch.int32, device=dev)
            )[:, None].expand(T, B).contiguous()
    c_state = clone_state(kern.state["C"])
    saved = kern.state["arena"]
    ar = {k: v.clone() for k, v in saved.items()}
    (m_f, _, trace), s_count = host_clock(lambda: ops.cer_pipeline(
        chunk, ve.encoder.specs, tb.class_of, tb.class_ind, tb.m_all,
        tb.finals[None, :], c_state, init_mask=tb.init_mask,
        window=ve.window, start_pos=start, impl="fused", return_trace=True,
        inplace=True))
    hits = (m_f > 0.5)[..., :1]

    def restore(a):
        for k, v in saved.items():
            a[k].copy_(v)
        return a
    (cells0, sstart0), s_cells = host_clock(
        lambda: tecs_arena.chunk_cells(ar))
    roots, s_kernel = host_clock(lambda: ops.arena_store_update(
        ar, cells0, sstart0, trace, hits, gpos, startv, validv,
        impl="fused", **kw))
    ar_p = {k: v.clone() for k, v in saved.items()}
    c_p, s_p = tecs_arena.chunk_cells(ar_p)
    roots_p = ops.arena_store_update(ar_p, c_p, s_p, trace, hits, gpos,
                                     startv, validv, impl="ref", **kw)
    err = max_abs_err(roots, roots_p)
    for k in ar:
        check(torch.equal(ar[k], ar_p[k]), f"{what}: arena_update store "
              f"kernel ≡ plain on one chunk ({k})")
        err = max(err, max_abs_err(ar[k], ar_p[k]))
    check(torch.equal(roots, roots_p), f"{what}: store kernel roots ≡ "
          "plain")
    check(not bool(ar["ovf"].any()), f"{what}: arena ovf stays clear")
    nodes = int((ar["ptr"] - saved["ptr"]).sum())
    folded = folded_slot_steps(saved["cell"], ar["cell"], T)
    del ar_p, c_p, s_p

    def host_side():
        counts = m_f[:, :, 0].cpu().numpy().astype(np.int64)
        hs = [(kern.position + int(t), int(b))
              for t, b in zip(*np.nonzero(counts))]
        roots_np = roots.cpu().numpy()
        return {h: roots_np[h[0] - kern.position, h[1]] for h in hs}
    recorded, s_host = host_clock(host_side)

    # the kernel alone (step operands prepared once) and the route
    xs, _ = ref.segment_operands(cells0, trace, hits, startv, validv,
                                 lay=lay, n_seg=1)
    fin_np = kw["finals_sq"].cpu().numpy()

    def setup():
        return tecs_arena.chunk_cells(restore(ar))
    ms = timed_ms(setup, lambda c0, s0: AKERNEL(
        ar, c0, s0, xs[:4], gpos, lay=lay, ptab=kw["ptab"],
        finals_sq=fin_np), reps=3)
    # where the kernel's time goes: the same chunk without hits (no roots,
    # no chain), and from an empty arena (one seeded slot a step, so
    # mostly the per-step fixed cost)
    xs_nohit = (xs[0], torch.zeros_like(xs[1])) + tuple(xs[2:4])
    no_hits_ms = timed_ms(setup, lambda c0, s0: AKERNEL(
        ar, c0, s0, xs_nohit, gpos, lay=lay, ptab=kw["ptab"],
        finals_sq=fin_np), reps=2)

    def setup_empty():
        tecs_arena.reset_arena(ar)
        return tecs_arena.chunk_cells(ar)
    empty_ms = timed_ms(setup_empty, lambda c0, s0: AKERNEL(
        ar, c0, s0, xs_nohit, gpos, lay=lay, ptab=kw["ptab"],
        finals_sq=fin_np), reps=2)
    route_ms = timed_ms(setup, lambda c0, s0: ops.arena_store_update(
        ar, c0, s0, trace, hits, gpos, startv, validv, impl="fused", **kw),
        reps=3)
    plain_ms = timed_ms(setup, lambda c0, s0: ops.arena_store_update(
        ar, c0, s0, trace, hits, gpos, startv, validv, impl="ref", **kw),
        reps=1)
    W, S, K, Q = ve.ring, at.num_states, at.max_indegree, 1
    bound = arena_bound(nodes, B, T, W, S, K, Q, folded)
    out = {"nodes_allocated": nodes, "folded_slot_steps": folded,
           "kernel_ms_per_chunk": ms, "route_ms_per_chunk": route_ms,
           "kernel_ms_without_hits": no_hits_ms,
           "kernel_ms_from_empty_arena": empty_ms,
           "plain_ms_per_chunk": plain_ms, "bound_ms": bound[0],
           "bound_by": bound[1], "bound_bytes": bound[2],
           "bound_int_ops": bound[3], "max_abs_err": err,
           "feed_steps_ms": {"counting_kernel": 1e3 * s_count,
                             "cell_gather": 1e3 * s_cells,
                             "arena_store_kernel": 1e3 * s_kernel,
                             "host_counts_hits_roots": 1e3 * s_host,
                             "hits": len(recorded)}}
    if not dense:
        return out
    # the old route from the same state: dense records (with their fill)
    # and the chunk-level translation; ≡ the store kernel
    cells_d, sstart_d = tecs_arena.chunk_cells(restore(ar))
    got, s_dense = host_clock(lambda: ops.arena_block_update(
        cells_d, trace, hits, startv, validv, impl="fused", **kw))
    (_, roots_d), s_store = host_clock(
        lambda: tecs_arena._arena_translate_store(
            ar, lay, *got, gpos, startv, validv, sstart_d, hits))
    ar_k = {k: v.clone() for k, v in saved.items()}
    c_k, s_k = tecs_arena.chunk_cells(ar_k)
    roots_k = ops.arena_store_update(ar_k, c_k, s_k, trace, hits, gpos,
                                     startv, validv, impl="fused", **kw)
    check(all(torch.equal(ar[k], ar_k[k]) for k in ar) and
          torch.equal(roots_d, roots_k), f"{what}: the old route (dense "
          "kernel and translation) ≡ the store kernel")
    del got, ar_k, c_k, s_k
    dense_ms = cuda_ms(lambda: ops.arena_block_update(
        cells_d, trace, hits, startv, validv, impl="fused", **kw), reps=2)
    got = ops.arena_block_update(cells_d, trace, hits, startv, validv,
                                 impl="fused", **kw)
    translate_ms = timed_ms(lambda: (restore(ar),), lambda a: (
        tecs_arena._arena_translate_store(a, lay, *got, gpos, startv,
                                          validv, sstart_d, hits)), reps=2)
    del got
    rec_bytes = 3 * B * T * lay.M * 4
    old_bytes = (rec_bytes + B * T * Q * 4 * 2 + 2 * 4 * B * W * S * 4
                 + 4 * T * B * 4 + at.pred_idx.size * 3 * 4)
    out.update(dense_kernel_ms_per_chunk=dense_ms,
               translate_ms_per_chunk=translate_ms,
               old_route_ms_per_chunk=dense_ms + translate_ms,
               old_route_steps_ms={"dense_kernel_with_fill": 1e3 * s_dense,
                                   "translate_and_store": 1e3 * s_store},
               dense_bound_ms=1e3 * old_bytes / PEAK_BYTES_PER_S,
               dense_bound_bytes=old_bytes, record_bytes=rec_bytes)
    return out


def enum_draws(ve, seed, B, T, n_chunks, types):
    """Uniform draws over ``types``; lane 0 draws A1-A3 rarely (1 % each),
    so the host Engine can enumerate every one of its matches."""
    rng = np.random.default_rng(seed)
    draws = rng.integers(0, len(types), (n_chunks * T, B))
    draws[:, 0] = rng.choice(len(types), n_chunks * T,
                             p=[0.01] * 3 + [0.97 / 6] * 6)
    codes = np.array([ve.encoder.vocab["type"].get(t, -1.0)
                      for t in types], np.float32)
    attrs_all = torch.from_numpy(codes[draws][:, :, None]).to(ve.device)
    return draws, [attrs_all[i * T:(i + 1) * T] for i in range(n_chunks)]


def enum_sample(kern, hits_k, counts_k, T, what):
    """Enumerate 32 hits of the second chunk (lanes past 0): each yields
    its count of complex events.  Returns (hits, complex events, first
    sync s, enumeration s)."""
    sample = [h for h in hits_k if T <= h[0] < 2 * T and h[1] > 0][:32]
    _, s_sync = host_clock(kern.arena_snapshot)
    res, s_enum = host_clock(lambda: kern.enumerate_hits(sample))
    n_ces = 0
    for (p, b), ces in res.items():
        check(len(ces) == counts_k[p, b], f"{what}: hit {(p, b)} "
              f"enumerates {len(ces)} of {counts_k[p, b]} matches")
        n_ces += len(ces)
    return len(sample), n_ces, s_sync, s_enum


def phase_enum(seed: int, B: int = 64, n_chunks: int = 8) -> dict:
    """The phase-1 query with the arena: B=64, ring 3208, M=57 738."""
    from repro_torch.core.events import Event
    from repro_torch.vector import (StreamingVectorEngine, VectorEngine,
                                    tecs_arena)
    T, eps, cap = 256, 3200, 1 << 18
    query = MAIN_QUERY.format(eps)
    types = ["A1", "A2", "A3"] + [f"B{i}" for i in range(1, 7)]
    ve = VectorEngine(query)
    draws, chunks = enum_draws(ve, seed + 5, B, T, n_chunks, types)
    kern = StreamingVectorEngine(ve, T, B, arena_capacity=cap)
    plain = StreamingVectorEngine(VectorEngine(query, impl="ref"), T, B,
                                  arena_capacity=cap)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_launches()
    feed_s, counts_k, hits_k = [], [], []
    for attrs in chunks:
        t0 = time.perf_counter()
        c, h = kern.feed_attrs(attrs)
        feed_s.append(time.perf_counter() - t0)
        counts_k.append(c)
        hits_k += h
    launches = read_launches(counters)
    want = {k: 0 for k in launches}
    want.update(fused_scan=n_chunks, arena_update=n_chunks)
    check(launches == want, f"phase 5 launched {launches}, expected one "
          "fused_scan and one arena_update store launch per chunk")
    check(kern.compile_count == 1, f"compile_count {kern.compile_count}")
    peak = torch.cuda.max_memory_allocated() / 1e9

    # the plain engine, chunk by chunk
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
    n_hits, n_ces, s_sync, s_enum = enum_sample(kern, hits_k, counts_k, T,
                                                "phase 5")
    snap = kern.arena_snapshot()
    for b in (0, 1, 2):
        tecs_arena.check_invariants(snap, b)

    # the arena kernels alone, on the next chunk from the saved state
    one = arena_chunk(kern, ve, chunks[0], B, T, cap, "phase 5", dense=True)
    at = ve.arena_tables()
    lay = tecs_arena._block_layout(at, ve.ring, ve.epsilon, cap)
    feed_med = float(np.median(feed_s))
    result = {
        "phase": 5, "query": query, "B": B, "T": T, "chunks": n_chunks,
        "W": ve.ring, "S": at.num_states, "K": at.max_indegree, "M": lay.M,
        "arena_capacity": cap, "launches": launches,
        "compile_count": kern.compile_count,
        "matches": int(counts_k.sum()), "hits": len(hits_k),
        "max_ptr": max_ptr, "lane0_complex_events": lane0_ces,
        "feed_ms_per_chunk_median": 1e3 * feed_med,
        "feed_ms_per_chunk": [1e3 * x for x in feed_s],
        "events_per_s": B * T / feed_med,
        "enum_hits": n_hits, "enum_complex_events": n_ces,
        "enum_first_sync_ms": 1e3 * s_sync, "enum_ms": 1e3 * s_enum,
        "enum_complex_events_per_s": n_ces / s_enum if s_enum else None,
        "peak_mem_GB": peak,
        "peak_mem_GB_with_checks": torch.cuda.max_memory_allocated() / 1e9}
    result.update(one)
    emit(result)
    return result


def phase_enum_wide(seed: int, B: int = 1024, n_chunks: int = 8,
                    n_check: int = 64) -> dict:
    """Enumeration at phase 1's width: phase 5's query and draws at 1024
    lanes through the store kernel; 64 lanes (lane 0 among them) ≡ a plain
    engine fed their columns, counts and hits ≡ an engine without the
    arena, lane 0 ≡ the host Engine."""
    from repro_torch.core.events import Event
    from repro_torch.vector import StreamingVectorEngine, VectorEngine
    T, eps, cap = 256, 3200, 1 << 18
    query = MAIN_QUERY.format(eps)
    types = ["A1", "A2", "A3"] + [f"B{i}" for i in range(1, 7)]
    ve = VectorEngine(query)
    draws, chunks = enum_draws(ve, seed + 15, B, T, n_chunks, types)
    kern = StreamingVectorEngine(ve, T, B, arena_capacity=cap)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_launches()
    feed_s, counts_k, hits_k = [], [], []
    for attrs in chunks:
        t0 = time.perf_counter()
        c, h = kern.feed_attrs(attrs)
        feed_s.append(time.perf_counter() - t0)
        counts_k.append(c)
        hits_k += h
    launches = read_launches(counters)
    want = {k: 0 for k in launches}
    want.update(fused_scan=n_chunks, arena_update=n_chunks)
    check(launches == want, f"phase 12 launched {launches}, expected one "
          "fused_scan and one arena_update store launch per chunk")
    check(kern.compile_count == 1, f"compile_count {kern.compile_count}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    counts_k = np.concatenate(counts_k)
    arena = kern.state["arena"]
    check(not bool(arena["ovf"].any()), "phase 12: arena ovf stays clear")

    # counts and hits ≡ the engine without the arena
    counting = StreamingVectorEngine(VectorEngine(query), T, B)
    out = [counting.feed_attrs(a) for a in chunks]
    check(same(np.concatenate([c for c, _ in out]), counts_k) and
          [h for _, hs in out for h in hs] == hits_k,
          "phase 12: counts and hits ≡ the engine without the arena")
    check(same(counting.state, kern.state["C"]),
          "phase 12: count state ≡ the engine without the arena")
    del counting, out

    # 64 lanes spread over the 1024, lane 0 among them, ≡ a plain engine
    # fed their columns (lanes are independent)
    rng = np.random.default_rng(seed + 16)
    lanes = [0] + sorted(int(x) for x in rng.choice(np.arange(1, B),
                                                    n_check - 1,
                                                    replace=False))
    plain = StreamingVectorEngine(VectorEngine(query, impl="ref"), T,
                                  n_check, arena_capacity=cap)
    idx = torch.tensor(lanes, device=ve.device)
    for attrs in chunks:
        plain.feed_attrs(attrs[:, idx].contiguous())
    pa = plain.state["arena"]
    for name in ("kind", "pos", "maxs", "left", "right", "cell", "ptr",
                 "ovf"):
        check(torch.equal(arena[name][idx], pa[name]),
              f"phase 12: {name} of 64 sampled lanes ≡ the plain engine")
    where = {b: i for i, b in enumerate(lanes)}
    mine = {(p, where[b]): v for (p, b), v in kern._roots.items()
            if b in where}
    check(mine.keys() == plain._roots.keys() and all(
        np.array_equal(mine[k], plain._roots[k]) for k in mine),
        "phase 12: roots of 64 sampled lanes ≡ the plain engine")
    del plain, pa

    lane0 = [Event(types[i], {}, position=p, timestamp=float(p))
             for p, i in enumerate(draws[:, 0])]
    lane0_ces = lane0_check(kern, hits_k, query, lane0, "phase 12")
    n_hits, n_ces, s_sync, s_enum = enum_sample(kern, hits_k, counts_k, T,
                                                "phase 12")
    one = arena_chunk(kern, ve, chunks[0], B, T, cap, "phase 12")
    feed_med = float(np.median(feed_s))
    result = {
        "phase": 12, "query": query, "B": B, "T": T, "chunks": n_chunks,
        "W": ve.ring, "arena_capacity": cap,
        "store_GB": 5 * B * (cap + 1) * 4 / 1e9,
        "cell_table_MB_per_buffer": 4 * B * ve.ring * 7 * 4 / 1e6,
        "launches": launches, "compile_count": kern.compile_count,
        "matches": int(counts_k.sum()), "hits": len(hits_k),
        "max_ptr": int(arena["ptr"].max()),
        "lane0_complex_events": lane0_ces, "checked_lanes": n_check,
        "feed_ms_per_chunk_median": 1e3 * feed_med,
        "feed_ms_per_chunk": [1e3 * x for x in feed_s],
        "events_per_s": B * T / feed_med,
        "enum_hits": n_hits, "enum_complex_events": n_ces,
        "enum_first_sync_ms": 1e3 * s_sync, "enum_ms": 1e3 * s_enum,
        "enum_complex_events_per_s": n_ces / s_enum if s_enum else None,
        "peak_mem_GB": peak,
        "peak_mem_GB_with_checks": torch.cuda.max_memory_allocated() / 1e9}
    result.update(one)
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


# ---------------------------------------------------------------------------
# the unfused pipeline and the packed multi-query engine: the bit-vector,
# cea_scan and cea_scan_multi kernels
# ---------------------------------------------------------------------------


def reset_launches() -> dict:
    """Every kernel wrapper's launch counter, set to 0."""
    from repro_torch.kernels import arena_update, bitvector, cea_scan
    from repro_torch.kernels import fused_scan
    counters = {"fused_scan": fused_scan.KERNEL,
                "arena_update": arena_update.KERNEL,
                "arena_update_dense": arena_update.DENSE,
                "bitvector": bitvector.KERNEL,
                "cea_scan": cea_scan.SINGLE,
                "cea_scan_multi": cea_scan.MULTI}
    for k in counters.values():
        k.launches = 0
    return counters


def read_launches(counters: dict) -> dict:
    return {name: k.launches for name, k in counters.items()}


def scan_bound(m_all, finals_q, cls, B, W, S, NQ):
    """Least time of one scan chunk: the sparse f32 arithmetic this run's
    classes need (the non-zeros of M_all[class] and of the finals, per ring
    slot), or the bytes moved once (ring in and out, class ids, matches,
    tables), whichever is larger.  Returns (ms, "bytes"|"operations",
    bytes, flops)."""
    T = cls.shape[0]
    nnz_m = (m_all != 0).sum(dim=(1, 2))
    flops = 2 * W * (int(nnz_m[cls.long()].sum())
                     + T * B * int((finals_q != 0).sum()))
    nbytes = 4 * (2 * B * W * S + T * B + T * B * NQ + m_all.numel()
                  + finals_q.numel() + S)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def phase_unfused(seed: int, main_run: dict, B: int = 1024,
                  n_chunks: int = 8) -> dict:
    """Phase 1's configuration through the unfused path: the streaming
    engine with impl="unfused" (bitvector + cea_scan_multi, Q=1) and
    VectorEngine.classify + scan (bitvector + cea_scan)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.vector import StreamingVectorEngine, VectorEngine
    T, eps = 256, 3200
    ve = VectorEngine(MAIN_QUERY.format(eps))
    t = ve.tables
    chunks = main_run["chunks"]
    check(len(chunks) == n_chunks and tuple(chunks[0].shape[:2]) == (T, B),
          "phase 8 feeds phase 1's chunks")
    un = StreamingVectorEngine(ve, T, B, impl="unfused")

    torch.cuda.synchronize()
    counters = reset_launches()
    feed_s, counts_u, hits_u = [], [], []
    for attrs in chunks:
        t0 = time.perf_counter()
        c, h = un.feed_attrs(attrs)
        feed_s.append(time.perf_counter() - t0)
        counts_u.append(c)
        hits_u += h
    feed_launches = read_launches(counters)
    check(feed_launches == {"fused_scan": 0, "arena_update": 0,
                            "arena_update_dense": 0,
                            "bitvector": n_chunks, "cea_scan": 0,
                            "cea_scan_multi": n_chunks},
          f"phase 8 unfused feed launched {feed_launches}")
    check(un.compile_count == 1, f"compile_count {un.compile_count}")
    counts_u = np.concatenate(counts_u)
    check(same(counts_u, main_run["counts"]) and hits_u == main_run["hits"],
          "phase 8: unfused counts and hits ≡ phase 1's fused (≡ plain)")
    check(same(un.state, main_run["ring"]), "phase 8: unfused ring ≡ fused")
    codes = torch.cat(chunks)[:, :8, 0].cpu().numpy().astype(np.int64)
    check(same(seq3_counts(codes, eps), counts_u[:, :8]),
          "phase 8: counts equal the closed-form count on 8 lanes")

    # the unfused feed against the fused feed on the host clock, in turns
    # (both engines restart from position 0)
    fu = StreamingVectorEngine(VectorEngine(MAIN_QUERY.format(eps)), T, B)
    un.reset()
    turns = {"fused": [], "unfused": []}
    for attrs in chunks:
        for name, se in (("fused", fu), ("unfused", un)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            se.feed_attrs(attrs)
            turns[name].append(time.perf_counter() - t0)
    check(same(fu.state, un.state), "phase 8: fused ≡ unfused after the "
          "feeds in turns")
    del fu

    # classify + scan: the single-query scan kernel
    counters = reset_launches()
    state, counts_s = ve.init_state(B), []
    for i, attrs in enumerate(chunks):
        m, state = ve.scan(ve.classify(attrs), state, start_pos=i * T)
        counts_s.append(m.cpu().numpy().astype(np.int64))
    scan_launches = read_launches(counters)
    check(scan_launches == {"fused_scan": 0, "arena_update": 0,
                            "arena_update_dense": 0,
                            "bitvector": n_chunks, "cea_scan": n_chunks,
                            "cea_scan_multi": 0},
          f"phase 8 classify + scan launched {scan_launches}")
    check(same(np.concatenate(counts_s), main_run["counts"]) and
          same(state, main_run["ring"]),
          "phase 8: classify + scan ≡ phase 1's fused run")
    del state

    # each kernel alone on chunk 0, from phase 1's final ring, against its
    # plain version on the same inputs
    attrs = chunks[0]
    flat = attrs.reshape(T * B, attrs.shape[2])
    specs = ve.encoder.specs
    bits_k, bits_p = ops.bitvector(flat, specs), ref.bitvector(flat, specs)
    check(same(bits_k, bits_p), "phase 8: bitvector kernel ≡ plain")
    ids = t.class_of[bits_k.long()].reshape(T, B)
    start = n_chunks * T
    res = {}
    for name, kern, plain in (
            ("cea_scan",
             lambda c: ops.cea_scan(ids, t.m_all, t.finals, c, epsilon=eps,
                                    start_pos=start, inplace=True),
             lambda c: ref.cea_scan(ids, t.m_all, t.finals, c, epsilon=eps,
                                    start_pos=start)),
            ("cea_scan_multi",
             lambda c: ops.cea_scan_multi(
                 ids, t.m_all, t.finals[None, :], c, init_mask=t.init_mask,
                 epsilon=eps, start_pos=start, inplace=True),
             lambda c: ref.cea_scan_multi(
                 ids, t.m_all, t.finals[None, :], c, init_mask=t.init_mask,
                 epsilon=eps, start_pos=start))):
        got = kern(main_run["ring"].clone())
        want = plain(main_run["ring"].clone())
        check(same(got[0], want[0]) and same(got[1], want[1]),
              f"phase 8: {name} kernel ≡ plain")
        err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        del got, want
        st_k, st_p = main_run["ring"].clone(), main_run["ring"].clone()
        bound = scan_bound(t.m_all, t.finals[None, :], ids, B, ve.ring,
                           t.num_states, 1)
        res[name] = {"ms": cuda_ms(lambda: kern(st_k), reps=5),
                     "plain_ms": cuda_ms(lambda: plain(st_p), reps=2),
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "bound_bytes": bound[2], "bound_flops": bound[3],
                     "max_abs_err": err}
        del st_k, st_p
    bv_bytes = 4 * (flat.numel() + T * B)
    bv_ops = len(specs) * T * B
    t_bytes, t_ops = bv_bytes / PEAK_BYTES_PER_S, bv_ops / PEAK_F32_FLOP_PER_S
    res["bitvector"] = {
        "ms": cuda_ms(lambda: ops.bitvector(flat, specs), reps=20),
        "plain_ms": cuda_ms(lambda: ref.bitvector(flat, specs), reps=5),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_bytes": bv_bytes, "max_abs_err": max_abs_err(bits_k, bits_p)}
    feed_med = float(np.median(feed_s))
    result = {"phase": 8, "query": MAIN_QUERY.format(eps), "B": B, "T": T,
              "chunks": n_chunks, "W": ve.ring, "S": t.num_states,
              "feed_launches": feed_launches,
              "classify_scan_launches": scan_launches,
              "compile_count": un.compile_count,
              "matches": int(counts_u.sum()), "hits": len(hits_u),
              "unfused_feed_ms_per_chunk_median": 1e3 * feed_med,
              "unfused_feed_ms_per_chunk": [1e3 * x for x in feed_s],
              "unfused_events_per_s": B * T / feed_med,
              "feed_ms_in_turns_median": {
                  k: 1e3 * float(np.median(v)) for k, v in turns.items()},
              "kernels": res}
    emit(result)
    return result


def packed_codes(types_tb: np.ndarray, names, query_types) -> np.ndarray:
    """A query's own 0/1/2 codes of a (T, B) type-index array, -1 for the
    types it does not read."""
    lut = np.array([query_types.index(n) if n in query_types else -1
                    for n in names], np.int64)
    return lut[types_tb]


def phase_packed(seed: int, B: int = 1024, n_chunks: int = 8) -> dict:
    """Four standing queries of the Fig. 8 shape packed into one engine
    (Ŝ = 28, k = 9, C = 512, ring 3208): fused, unfused and plain."""
    from repro_torch.kernels import ops, ref
    from repro_torch.vector import MultiQueryEngine, StreamingVectorEngine
    T, eps = 256, 3200
    queries = [PACKED_QUERY.format(q, eps) for q in PACKED_SEQS]
    types = ["A1", "A2", "A3"] + [f"B{i}" for i in range(1, 7)]
    mq = MultiQueryEngine(queries)
    pk, t = mq.packing, mq.tables
    check(mq.packed_states == 28 and pk.num_bits == 9 and
          pk.num_classes == 512 and mq.ring == 3208,
          "packed geometry is Ŝ=28, k=9, C=512, ring 3208")
    rng = np.random.default_rng(seed + 9)
    draws = rng.integers(0, len(types), (n_chunks * T, B))
    codes = np.array([mq.encoder.vocab["type"][x] for x in types],
                     np.float32)
    attrs_all = torch.from_numpy(codes[draws][:, :, None]).to(mq.device)
    chunks = [attrs_all[i * T:(i + 1) * T] for i in range(n_chunks)]
    engines = {impl: StreamingVectorEngine(
        mq if impl == "fused" else MultiQueryEngine(queries, impl=impl),
        T, B) for impl in ("fused", "unfused", "ref")}
    runs = {}
    for impl, se in engines.items():
        torch.cuda.synchronize()
        counters = reset_launches()
        feed_s, counts, hits = [], [], []
        for attrs in chunks:
            t0 = time.perf_counter()
            c, h = se.feed_attrs(attrs)
            feed_s.append(time.perf_counter() - t0)
            counts.append(c)
            hits += h
        runs[impl] = {"counts": np.concatenate(counts), "hits": hits,
                      "feed_s": feed_s, "launches": read_launches(counters)}
        if impl == "fused":
            plan = counters["fused_scan"].last_plan
            check(plan[0] and plan[1] >= 2, f"phase 9's ring (372 KB a "
                  f"lane) is split over blocks in shared memory, got {plan}")
        if impl == "unfused":
            scan_plan = counters["cea_scan_multi"].last_plan
            check(scan_plan[0] and scan_plan[1] >= 2, f"phase 9's unfused "
                  f"ring is split over blocks in shared memory, got "
                  f"{scan_plan}")
    want = {"fused": dict(fused_scan=n_chunks),
            "unfused": dict(bitvector=n_chunks, cea_scan_multi=n_chunks),
            "ref": {}}
    for impl, run in runs.items():
        expect = {k: want[impl].get(k, 0) for k in run["launches"]}
        check(run["launches"] == expect,
              f"phase 9 {impl} launched {run['launches']}")
    for impl in ("fused", "unfused"):
        check(engines[impl].compile_count == 1,
              f"phase 9 {impl}: compile_count "
              f"{engines[impl].compile_count}")
        check(same(runs[impl]["counts"], runs["ref"]["counts"]) and
              runs[impl]["hits"] == runs["ref"]["hits"],
              f"phase 9: {impl} counts and hits ≡ plain")
        check(same(engines[impl].state, engines["ref"].state),
              f"phase 9: {impl} ring ≡ plain")
    counts = runs["fused"]["counts"]
    check(counts.shape == (n_chunks * T, B, 4),
          "phase 9 counts are (T, B, 4)")
    check(counts.max() < EXACT_LIMIT and
          float(engines["fused"].state.max()) < EXACT_LIMIT,
          "phase 9: counts and ring stay below 2^24")
    for q, seq in enumerate(PACKED_SEQS):
        own = packed_codes(draws[:, :8], types, seq.split(" ; "))
        check(same(seq3_counts(own, eps), counts[:, :8, q]),
              f"phase 9: query {seq} equals its closed form on 8 lanes")

    # classify + scan ≡ pipeline, from a fresh state, on chunk 0
    ids = mq.classify(chunks[0])
    m_s, st_s = mq.scan(ids, mq.init_state(B))
    m_p, st_p = mq.pipeline(chunks[0], mq.init_state(B))
    check(same(m_s, m_p) and same(st_s, st_p),
          "phase 9: classify + scan ≡ pipeline")
    del st_s, st_p

    # the kernels alone on chunk 0 from the final ring: cea_scan_multi at
    # its default split and forced ones, each ≡ the plain version
    ring = engines["fused"].state
    start = n_chunks * T
    kw = dict(init_mask=t.init_mask, epsilon=eps, start_pos=start)
    want_ = ref.cea_scan_multi(ids, t.m_all, t.finals, ring.clone(), **kw)
    scan_split_ms, err = {}, 0.0
    for split in (None, 2, 4):
        got = ops.cea_scan_multi(ids, t.m_all, t.finals, ring.clone(),
                                 split=split, **kw)
        check(same(got[0], want_[0]) and same(got[1], want_[1]),
              f"phase 9: cea_scan_multi split={split} kernel ≡ plain")
        err = max(err, max_abs_err(got[0], want_[0]),
                  max_abs_err(got[1], want_[1]))
        del got
        st_k = ring.clone()
        scan_split_ms[str(split or "default")] = cuda_ms(
            lambda: ops.cea_scan_multi(ids, t.m_all, t.finals, st_k,
                                       inplace=True, split=split, **kw),
            reps=3)
        del st_k
    del want_
    ms = scan_split_ms["default"]
    st_p = ring.clone()
    plain_ms = cuda_ms(lambda: ref.cea_scan_multi(ids, t.m_all, t.finals,
                                                  st_p, **kw), reps=1)
    # the fused kernel alone: the default split and forced ones, each ≡
    # the plain version on chunk 0 from the final ring
    def fused(st, impl="fused", split=None):
        return ops.cer_pipeline(
            chunks[0], mq.encoder.specs, t.class_of, t.class_ind, t.m_all,
            t.finals, st, init_mask=t.init_mask, window=mq.window,
            start_pos=start, impl=impl, split=split, inplace=True)
    want_f = fused(ring.clone(), impl="ref")
    fused_split_ms = {}
    for split in (None, 2, 4, 8):
        got = fused(ring.clone(), split=split)
        check(same(got[0], want_f[0]) and same(got[1], want_f[1]),
              f"phase 9: fused_scan split={split} ≡ plain on one chunk")
        del got
        st_f = ring.clone()
        fused_split_ms[str(split or "default")] = cuda_ms(
            lambda: fused(st_f, split=split), reps=3)
        del st_f
    del want_f
    fused_ms = fused_split_ms["default"]
    del st_p
    bound = scan_bound(t.m_all, t.finals, ids, B, mq.ring, 28, 4)
    med = {impl: float(np.median(run["feed_s"])) for impl, run in
           runs.items()}
    result = {"phase": 9, "queries": queries, "B": B, "T": T,
              "chunks": n_chunks, "W": mq.ring, "S": mq.packed_states,
              "k": pk.num_bits, "C": pk.num_classes,
              "ring_MB": B * mq.ring * 28 * 4 / 1e6,
              "launches": {impl: run["launches"] for impl, run in
                           runs.items()},
              "compile_count": engines["fused"].compile_count,
              "matches_per_query": [int(x) for x in
                                    counts.sum(axis=(0, 1))],
              "max_count": int(counts.max()),
              "feed_ms_per_chunk_median": {k: 1e3 * v
                                           for k, v in med.items()},
              "events_per_s": {k: B * T / v for k, v in med.items()},
              "cea_scan_multi_ms": ms, "cea_scan_multi_plain_ms": plain_ms,
              "cea_scan_multi_n_split": scan_plan[1],
              "cea_scan_multi_ms_by_n_split": scan_split_ms,
              "fused_scan_ms": fused_ms, "fused_scan_n_split": plan[1],
              "fused_scan_ms_by_n_split": fused_split_ms,
              "bound_ms": bound[0], "bound_by": bound[1],
              "bound_bytes": bound[2], "bound_flops": bound[3],
              "max_abs_err": err,
              "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9}
    del engines, runs, attrs_all, chunks, ring
    result.update(packed_arena(seed))
    emit(result)
    return result


def packed_arena(seed: int, B: int = 16, n_chunks: int = 2,
                 seqs=PACKED_SEQS) -> dict:
    """Correctness of the packed tECS arena: the queries at a window of
    300 events, 16 lanes; store ≡ plain, lane 0 ≡ the host Engine."""
    from repro_torch.core.events import Event
    from repro_torch.kernels.arena_update import KERNEL as AKERNEL
    from repro_torch.vector import MultiQueryEngine, StreamingVectorEngine
    T, eps, cap = 256, 300, 1 << 18
    queries = [PACKED_QUERY.format(q, eps) for q in seqs]
    types = ["A1", "A2", "A3"] + [f"B{i}" for i in range(1, 7)] + ["C1"]
    rng = np.random.default_rng(seed + 10)
    draws = rng.integers(0, 9, (n_chunks * T, B))
    # lane 0 draws the queries' types rarely, so the host Engine can
    # enumerate every one of its matches
    draws[:, 0] = rng.choice(len(types), n_chunks * T,
                             p=[0.02] * 9 + [0.82])
    mq = MultiQueryEngine(queries)
    codes = np.array([mq.encoder.vocab["type"].get(x, -1.0) for x in types],
                     np.float32)
    attrs_all = torch.from_numpy(codes[draws][:, :, None]).to(mq.device)
    kern = StreamingVectorEngine(mq, T, B, arena_capacity=cap)
    plain = StreamingVectorEngine(MultiQueryEngine(queries, impl="ref"), T,
                                  B, arena_capacity=cap)
    counts, hits = [], []
    launches = AKERNEL.launches
    for i in range(n_chunks):
        attrs = attrs_all[i * T:(i + 1) * T]
        ck, hk = kern.feed_attrs(attrs)
        cp, hp = plain.feed_attrs(attrs)
        check(same(ck, cp) and hk == hp, "packed arena: counts kernel ≡ "
              "plain")
        counts.append(ck)
        hits += hk
    check(AKERNEL.launches == launches + n_chunks,
          "packed arena: one arena_update launch per chunk")
    check_engines_equal(kern, plain, "packed arena")
    del plain
    check(not bool(kern.state["arena"]["ovf"].any()),
          "packed arena: ovf stays clear")
    counts = np.concatenate(counts)
    lane0 = [Event(types[i], {}, position=p, timestamp=float(p))
             for p, i in enumerate(draws[:, 0])]
    n_ces = []
    for q, query in enumerate(queries):
        q_hits = [(p, b) for p, b in hits if b == 0 and counts[p, 0, q]]
        got = {p: ceset(v) for (p, _), v in
               kern.enumerate_hits(q_hits, query=q).items()}
        want = host_sets(query, lane0)
        check(got == want, f"packed arena query {q}: lane 0 enumerates "
              f"what the host Engine finds "
              f"({sum(map(len, got.values()))} vs "
              f"{sum(map(len, want.values()))} complex events)")
        n_ces.append(sum(map(len, want.values())))
    return {"arena_B": B, "arena_window": eps, "arena_hits": len(hits),
            "arena_matches": int(counts.sum()),
            "arena_lane0_complex_events": n_ces,
            "arena_max_ptr": int(kern.state["arena"]["ptr"].max())}


def phase_nine(seed: int, B: int = 1024, n_chunks: int = 8) -> dict:
    """Nine standing queries of the Fig. 8 shape packed into one engine
    (Ŝ = 63, NQ = 9, k = 9, ring 3208): the wide build of both counting
    kernels and query groups past 8; fused and unfused feeds, plain on one
    chunk; then the packed arena at a window of 300 events."""
    from repro_torch.kernels import ops, ref
    from repro_torch.vector import (MultiQueryEngine, StreamingVectorEngine,
                                    tecs_arena)
    T, eps = 256, 3200
    queries = [PACKED_QUERY.format(q, eps) for q in NINE_SEQS]
    types = ["A1", "A2", "A3"] + [f"B{i}" for i in range(1, 7)]
    mq = MultiQueryEngine(queries)
    pk, t = mq.packing, mq.tables
    S, NQ, W = mq.packed_states, t.finals.shape[0], mq.ring
    check(S == 63 and NQ == 9 and W == 3208 and pk.num_bits == 9,
          f"phase 11 geometry is Ŝ=63, NQ=9, k=9, ring 3208, got Ŝ={S} "
          f"NQ={NQ} ring {W} k={pk.num_bits}")
    rng = np.random.default_rng(seed + 14)
    draws = rng.integers(0, len(types), (n_chunks * T, B))
    codes = np.array([mq.encoder.vocab["type"][x] for x in types],
                     np.float32)
    attrs_all = torch.from_numpy(codes[draws][:, :, None]).to(mq.device)
    chunks = [attrs_all[i * T:(i + 1) * T] for i in range(n_chunks)]
    engines = {"fused": StreamingVectorEngine(mq, T, B),
               "unfused": StreamingVectorEngine(
                   MultiQueryEngine(queries, impl="unfused"), T, B)}
    runs, ring_before_last = {}, None
    for impl, se in engines.items():
        torch.cuda.synchronize()
        counters = reset_launches()
        feed_s, counts, hits = [], [], []
        for i, attrs in enumerate(chunks):
            if impl == "fused" and i == n_chunks - 1:
                ring_before_last = se.state.clone()
            t0 = time.perf_counter()
            c, h = se.feed_attrs(attrs)
            feed_s.append(time.perf_counter() - t0)
            counts.append(c)
            hits += h
        runs[impl] = {"counts": np.concatenate(counts), "hits": hits,
                      "feed_s": feed_s, "launches": read_launches(counters)}
        kern = counters["fused_scan" if impl == "fused" else
                        "cea_scan_multi"]
        runs[impl]["plan"] = kern.last_plan
        check(kern.last_plan[0] and kern.last_plan[1] >= 2,
              f"phase 11 {impl}: the ring (812 KB a lane) is split over "
              f"blocks in shared memory, got {kern.last_plan}")
        check(se.compile_count == 1, f"phase 11 {impl}: compile_count "
              f"{se.compile_count}")
    want = {"fused": dict(fused_scan=n_chunks),
            "unfused": dict(bitvector=n_chunks, cea_scan_multi=n_chunks)}
    for impl, run in runs.items():
        expect = {k: want[impl].get(k, 0) for k in run["launches"]}
        check(run["launches"] == expect,
              f"phase 11 {impl} launched {run['launches']}")
    counts = runs["fused"]["counts"]
    check(same(runs["unfused"]["counts"], counts) and
          runs["unfused"]["hits"] == runs["fused"]["hits"] and
          same(engines["unfused"].state, engines["fused"].state),
          "phase 11: unfused counts, hits and ring ≡ fused")
    check(counts.shape == (n_chunks * T, B, 9) and
          counts.max() < EXACT_LIMIT and
          float(engines["fused"].state.max()) < EXACT_LIMIT,
          "phase 11: counts are (T, B, 9) and stay below 2^24")
    for q, seq in enumerate(NINE_SEQS):
        own = packed_codes(draws[:, :8], types, seq.split(" ; "))
        check(same(seq3_counts(own, eps), counts[:, :8, q]),
              f"phase 11: query {seq} equals its closed form on 8 lanes")
    del engines["unfused"]

    # the plain version on the last chunk, from the ring before it
    last = chunks[-1]
    start = ((n_chunks - 1) * T) % W
    kw = dict(init_mask=t.init_mask, window=mq.window, start_pos=start)
    m_p, ring_p = ops.cer_pipeline(
        last, mq.encoder.specs, t.class_of, t.class_ind, t.m_all, t.finals,
        ring_before_last, impl="ref", **kw)
    counts_p = m_p.cpu().numpy().astype(np.int64)
    hits_p = [((n_chunks - 1) * T + int(p), int(b))
              for p, b in zip(*np.nonzero(counts_p.sum(axis=-1)))]
    check(same(counts_p, counts[-T:]) and
          hits_p == [h for h in runs["fused"]["hits"]
                     if h[0] >= (n_chunks - 1) * T] and
          same(ring_p, engines["fused"].state),
          "phase 11: counts, hits and ring of the last chunk ≡ plain")
    err = max_abs_err(ring_p, engines["fused"].state)
    del ring_p, m_p

    # each kernel alone on the last chunk, from the ring before it
    ids = mq.classify(last)
    st = ring_before_last.clone()
    fused_ms = cuda_ms(lambda: ops.cer_pipeline(
        last, mq.encoder.specs, t.class_of, t.class_ind, t.m_all, t.finals,
        st, inplace=True, **kw), reps=3)
    st.copy_(ring_before_last)
    scan_ms = cuda_ms(lambda: ops.cea_scan_multi(
        ids, t.m_all, t.finals, st, init_mask=t.init_mask, epsilon=eps,
        start_pos=start, inplace=True), reps=3)
    st.copy_(ring_before_last)
    plain_ms = cuda_ms(lambda: ref.cea_scan_multi(
        ids, t.m_all, t.finals, st, init_mask=t.init_mask, epsilon=eps,
        start_pos=start), reps=1)
    del st, ring_before_last
    bound = scan_bound(t.m_all, t.finals, ids, B, W, S, NQ)
    med = {impl: float(np.median(run["feed_s"])) for impl, run in
           runs.items()}
    result = {"phase": 11, "queries": queries, "B": B, "T": T,
              "chunks": n_chunks, "W": W, "S": S, "NQ": NQ,
              "k": pk.num_bits, "C": pk.num_classes,
              "ring_MB": B * W * S * 4 / 1e6,
              "launches": {impl: run["launches"] for impl, run in
                           runs.items()},
              "compile_count": engines["fused"].compile_count,
              "matches_per_query": [int(x) for x in
                                    counts.sum(axis=(0, 1))],
              "max_count": int(counts.max()),
              "feed_ms_per_chunk_median": {k: 1e3 * v
                                           for k, v in med.items()},
              "feed_ms_per_chunk": {k: [1e3 * x for x in run["feed_s"]]
                                    for k, run in runs.items()},
              "events_per_s": {k: B * T / v for k, v in med.items()},
              "fused_scan_ms": fused_ms,
              "fused_scan_n_split": runs["fused"]["plan"][1],
              "cea_scan_multi_ms": scan_ms,
              "cea_scan_multi_n_split": runs["unfused"]["plan"][1],
              "plain_ms": plain_ms,
              "bound_ms": bound[0], "bound_by": bound[1],
              "bound_bytes": bound[2], "bound_flops": bound[3],
              "max_abs_err": err,
              "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9}
    del engines, runs, attrs_all, chunks
    result.update(packed_arena(seed, seqs=NINE_SEQS))
    lay_mq = MultiQueryEngine([PACKED_QUERY.format(q, 300)
                               for q in NINE_SEQS])
    lay = tecs_arena._block_layout(lay_mq.arena_tables(), lay_mq.ring,
                                   lay_mq.epsilon, 1 << 18)
    check((lay.S, lay.Q) == (63, 9), f"phase 11 arena takes S=63, Q=9, "
          f"got S={lay.S} Q={lay.Q}")
    result.update(arena_S=lay.S, arena_Q=lay.Q, arena_M=lay.M)
    emit(result)
    return result


def phase_edges(seed: int, dev="cuda") -> None:
    """Edge shapes of the three kernels against their plain versions, and
    the routers' refusals."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import window as wkern
    rng = np.random.default_rng(seed + 11)
    n = 0
    for N, A, k in ((1, 1, 6), (7, 3, 6), (300, 8, 14)):
        attrs = rng.normal(size=(N, A)).astype(np.float32)
        attrs[rng.random((N, A)) < 0.2] = np.nan
        attrs[rng.random((N, A)) < 0.2] = 0.0
        specs = [(int(rng.integers(0, A)), i % 6,
                  float(rng.choice([0.0, rng.normal()]))) for i in range(k)]
        x = torch.from_numpy(attrs).to(dev)
        check(same(ops.bitvector(x, specs), ref.bitvector(x, specs)),
              f"phase 10: bitvector kernel ≡ plain at N={N} A={A} k={k}")
        n += 1
    # S in each bucket, the wide build and query groups past 8; rings of
    # exactly ε+1 and padded; start 0 and a chunked carry; two successors
    # per row, entries of 2 where they meet; each at the default plan and
    # forced splits (W=7 split 5 is trimmed to 4 blocks)
    from repro_torch.kernels import cea_scan as scan_kernels
    from repro_torch.kernels.fused_scan import plan_ring
    for S, NQ, eps, W in ((5, 1, 6, 7), (5, 2, 6, 16), (12, 3, 9, 10),
                          (12, 8, 9, 24), (28, 4, 7, 8), (28, 1, 7, 13),
                          (40, 9, 6, 7), (63, 12, 9, 24), (24, 17, 7, 8)):
        M = np.zeros((6, S, S), np.float32)
        for s in range(1, S):
            for c in range(6):
                for _ in range(2):
                    tgt = rng.integers(0, S)
                    if tgt:
                        M[c, s, tgt] += 1
        finals = (rng.random((NQ, S)) < 0.4).astype(np.float32)
        finals[:, 0] = 0.0
        init = np.zeros(S, np.float32)
        init[rng.choice(np.arange(1, S), min(NQ, S - 1),
                        replace=False)] = 1.0
        B, T = 37, 96
        ids = torch.from_numpy(rng.integers(0, 6, (T, B)).astype(
            np.int32)).to(dev)
        Mt, ft, it = (torch.from_numpy(a).to(dev) for a in (M, finals, init))
        c0 = torch.zeros((B, W, S), device=dev)
        for split in (None, 2, 5):
            want_plan = plan_ring(W, S, False, 10 ** 6, latest=False,
                                  consume=False, split=split)
            for name, kern, entry, plain in (
                    ("cea_scan_multi", scan_kernels.MULTI,
                     lambda i, c, s, sp: ops.cea_scan_multi(
                         i, Mt, ft, c, init_mask=it, epsilon=eps,
                         start_pos=s, split=sp),
                     lambda i, c, s: ref.cea_scan_multi(
                         i, Mt, ft, c, init_mask=it, epsilon=eps,
                         start_pos=s)),
                    ("cea_scan", scan_kernels.SINGLE,
                     lambda i, c, s, sp: ops.cea_scan(
                         i, Mt, ft[0], c, epsilon=eps, start_pos=s,
                         split=sp),
                     lambda i, c, s: ref.cea_scan(
                         i, Mt, ft[0], c, epsilon=eps, start_pos=s))):
                full_k = entry(ids, c0, 0, split)
                check(kern.last_plan == want_plan, f"phase 10: {name} "
                      f"split={split} ran {kern.last_plan}, expected "
                      f"{want_plan}")
                full_p = plain(ids, c0, 0)
                m1, c1 = entry(ids[:40], c0, 0, split)
                m2, c2 = entry(ids[40:], c1, 40, split)
                check(same(full_k[0], full_p[0]) and
                      same(full_k[1], full_p[1]),
                      f"phase 10: {name} kernel ≡ plain at S={S} NQ={NQ} "
                      f"W={W} split={split}")
                check(same(torch.cat([m1, m2]), full_k[0]) and
                      same(c2, full_k[1]),
                      f"phase 10: {name} chunked carry at S={S} W={W} "
                      f"split={split}")
                check(float(full_k[0].max()) < EXACT_LIMIT,
                      "phase 10: counts stay below 2^24")
                n += 1

    # forced splits of the fused kernel against its plain version: rings
    # of exactly ε+1, 28 states, the wide build, query groups past 8, start
    # 0 and a chunked carry, time windows
    from repro_torch.kernels.fused_scan import KERNEL as FKERNEL
    for S, NQ, eps, W, split in ((5, 1, 6, 7, 2), (5, 2, 6, 7, 3),
                                 (28, 4, 7, 8, 3), (12, 8, 9, 23, 5),
                                 (7, 2, None, 37, 2), (28, 3, None, 37, 5),
                                 (40, 9, 6, 7, 3), (45, 10, None, 29, 4)):
        timed = eps is None
        B, T, A, k, C = 37, 96, 3, 4, 6
        # two successors per row under a count window (entries of 2 where
        # they meet); one under the longer time window, so counts stay
        # below 2^24
        M = np.zeros((C, S, S), np.float32)
        for s in range(1, S):
            for c in range(C):
                for _ in range(1 if timed else 2):
                    tgt = rng.integers(0, S)
                    if tgt:
                        M[c, s, tgt] += 1
        finals = (rng.random((NQ, S)) < 0.4).astype(np.float32)
        finals[:, 0] = 0.0
        init = np.zeros(S, np.float32)
        init[rng.choice(np.arange(1, S), NQ, replace=False)] = 1.0
        specs = [(int(rng.integers(0, A)), int(rng.integers(0, 6)),
                  float(np.float32(rng.normal()))) for _ in range(k)]
        class_of, attrs, ts, Mt, ft, it = (
            torch.from_numpy(x).to(dev) for x in (
                rng.integers(0, C, 1 << k).astype(np.int32),
                rng.normal(size=(T, B, A)).astype(np.float32),
                np.cumsum(rng.integers(0, 3, (T, B)), axis=0).astype(
                    np.float32),
                M, finals, init))
        window = (wkern.DeviceWindow("time", 6.0, ring=W) if timed else
                  wkern.DeviceWindow("events", float(eps), ring=W))
        c0 = wkern.init_state(window, B, S, dev)

        def pipe(lo, hi, c, impl, split=None):
            return ops.cer_pipeline(
                attrs[lo:hi], specs, class_of, None, Mt, ft, c,
                init_mask=it, window=window,
                event_ts=ts[lo:hi] if timed else None, start_pos=lo,
                impl=impl, split=split)
        full_k = pipe(0, T, c0, "fused", split)
        check(FKERNEL.last_plan == (True, split),
              f"phase 10: forced split {split} ran {FKERNEL.last_plan}")
        full_p = pipe(0, T, c0, "ref")
        m1, c1 = pipe(0, 40, c0, "fused", split)
        m2, c2 = pipe(40, T, c1, "fused", split)
        check(same(full_k[0], full_p[0]) and same(full_k[1], full_p[1]),
              f"phase 10: fused_scan split={split} ≡ plain at S={S} NQ={NQ} "
              f"W={W} timed={timed}")
        check(same(torch.cat([m1, m2]), full_k[0]) and same(c2, full_k[1]),
              f"phase 10: fused_scan split={split} chunked carry at S={S} "
              f"W={W}")
        check(float(full_k[0].max()) < EXACT_LIMIT,
              "phase 10: counts stay below 2^24")
        n += 1

    n += pad512_case(seed, dev)
    n += former_refusals(seed, dev)

    # what the routers refuse, before any launch
    counters = reset_launches()
    S, NQ = 6, 2
    ids = torch.zeros((4, 2), dtype=torch.int32, device=dev)

    def scan(S, NQ, W, eps, **kw):
        return ops.cea_scan_multi(
            ids, torch.zeros((3, S, S), device=dev),
            torch.zeros((NQ, S), device=dev),
            torch.zeros((2, W, S), device=dev),
            init_mask=torch.zeros(S, device=dev), epsilon=eps, **kw)
    pipe_args = (torch.zeros((4, 2, 1), device=dev), ((0, 0, 0.0),),
                 torch.zeros(2, dtype=torch.int32, device=dev), None,
                 torch.zeros((1, S, S), device=dev),
                 torch.zeros((NQ, S), device=dev))
    c0 = torch.zeros((2, 8, S), device=dev)
    init = torch.zeros(S, device=dev)
    refusals = [("S > 512", lambda: scan(513, 1, 8, 3)),
                ("W < eps+1", lambda: scan(12, 2, 3, 3)),
                ("a scan split past the ring", lambda: scan(12, 2, 8, 3,
                                                            split=9)),
                ("per-lane start_pos in the scan router", lambda: scan(
                    12, 2, 8, 3, start_pos=torch.zeros(2, device=dev))),
                ("k > 31", lambda: ops.bitvector(
                    torch.zeros((3, 1), device=dev), [(0, 0, 0.0)] * 32)),
                ("fused S > 512", lambda: ops.cer_pipeline(
                    *pipe_args[:4], torch.zeros((1, 513, 513), device=dev),
                    torch.zeros((NQ, 513), device=dev),
                    torch.zeros((2, 8, 513), device=dev),
                    init_mask=torch.zeros(513, device=dev), epsilon=5))]
    for what, kw in (("LAST", dict(latest_q=torch.ones(NQ, device=dev))),
                     ("CONSUME", dict(consume_sq=torch.ones((NQ, S),
                                                            device=dev))),
                     ("a ring of 8", dict(split=9))):
        refusals.append((f"a forced split with {what}", lambda kw=kw: (
            ops.cer_pipeline(*pipe_args, c0, init_mask=init, epsilon=5,
                             impl="fused", **{"split": 2, **kw}))))
    for what, fn in refusals:
        try:
            fn()
        except ValueError:
            continue
        check(False, f"phase 10: the router accepted {what}")
    check(all(v == 0 for v in read_launches(counters).values()),
          "phase 10: refused calls launched nothing")
    torch.cuda.synchronize()
    emit({"phase": 10, "kernel_cases": n, "refusals": len(refusals),
          "max_abs_err": 0.0})


def pad512_case(seed: int, dev) -> int:
    """A pack padded to 512 states and 16 query slots over few classes,
    small B and W: fused and unfused feeds, classify + scan and the
    arena ≡ the plain version."""
    from repro_torch.vector import MultiQueryEngine, StreamingVectorEngine
    from repro_torch.vector.multiquery import build_packing
    queries = ["SELECT * FROM S WHERE A1 ; A2+ ; A3 WITHIN 12 events",
               "SELECT * FROM S WHERE A2 ; A1 WITHIN 12 events"]

    def engine(impl):
        return MultiQueryEngine.from_packing(
            build_packing(queries, pad_states=512, pad_queries=16),
            impl=impl, device=dev)
    mq = engine("fused")
    check(mq.packed_states == 512 and mq.tables.finals.shape[0] == 16 and
          mq.packing.num_classes <= 8, "phase 10: the padded pack has 512 "
          "states, 16 query slots and few classes")
    B, T = 8, 64
    rng = np.random.default_rng(seed + 12)
    types = ["A1", "A2", "A3", "B1"]
    codes = np.array([mq.encoder.vocab["type"].get(x, -1.0) for x in types],
                     np.float32)
    chunks = [torch.from_numpy(codes[rng.integers(0, 4, (T, B))][:, :, None]
                               ).to(dev) for _ in range(3)]
    runs = {}
    for impl, cap in (("fused", None), ("unfused", None), ("ref", None),
                      ("fused", 1 << 12)):
        se = StreamingVectorEngine(mq if impl == "fused" and cap is None
                                   else engine(impl), T, B,
                                   arena_capacity=cap)
        out = [se.feed_attrs(a) for a in chunks]
        runs[(impl, cap)] = (np.concatenate([c for c, _ in out]),
                             [h for _, hs in out for h in hs],
                             (se.state["C"] if cap else se.state).clone())
    want = runs[("ref", None)]
    check(int(want[0].sum()) > 0, "phase 10: the padded pack matches")
    for key, got in runs.items():
        check(same(got[0], want[0]) and got[1] == want[1] and
              same(got[2], want[2]), f"phase 10: padded pack {key} ≡ plain")
    ids = mq.classify(chunks[0])
    m_s, st_s = mq.scan(ids, mq.init_state(B))
    m_p, st_p = engine("ref").pipeline(chunks[0], mq.init_state(B))
    check(same(m_s, m_p) and same(st_s, st_p),
          "phase 10: padded pack classify + scan ≡ plain")
    return len(runs) + 1


def former_refusals(seed: int, dev) -> int:
    """33 states and 9 queries in the scan kernels ≡ plain; the unfused
    pipeline with per-lane offsets, valid counts, LAST, CONSUME or a time
    window goes to the fused kernel (one launch, nothing else) ≡
    impl="fused" ≡ plain."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import window as wkern
    rng = np.random.default_rng(seed + 13)
    T, B, n = 16, 5, 0
    for S, NQ in ((33, 1), (12, 9)):
        M = np.zeros((3, S, S), np.float32)
        for s in range(1, S):
            M[:, s, rng.integers(1, S, 3)] = 1.0
        ids = torch.from_numpy(rng.integers(0, 3, (T, B)).astype(
            np.int32)).to(dev)
        Mt = torch.from_numpy(M).to(dev)
        ft = torch.from_numpy((rng.random((NQ, S)) < 0.5).astype(
            np.float32)).to(dev)
        it = torch.zeros(S, device=dev)
        it[1] = 1.0
        c0 = torch.from_numpy((rng.random((B, 8, S)) < 0.2).astype(
            np.float32)).to(dev)
        got = ops.cea_scan_multi(ids, Mt, ft, c0, init_mask=it, epsilon=3)
        want = ref.cea_scan_multi(ids, Mt, ft, c0, init_mask=it, epsilon=3)
        check(same(got[0], want[0]) and same(got[1], want[1]),
              f"phase 10: cea_scan_multi at S={S} NQ={NQ} ≡ plain")
        n += 1
    S, NQ, A, k, C = 6, 2, 2, 3, 4
    M = np.zeros((C, S, S), np.float32)
    for s in range(1, S):
        M[:, s, rng.integers(1, S, C)] = 1.0
    args = (torch.from_numpy(rng.normal(size=(T, B, A)).astype(
                np.float32)).to(dev),
            [(int(rng.integers(0, A)), int(rng.integers(0, 6)),
              float(np.float32(rng.normal()))) for _ in range(k)],
            torch.from_numpy(rng.integers(0, C, 1 << k).astype(
                np.int32)).to(dev), None, torch.from_numpy(M).to(dev),
            torch.from_numpy((rng.random((NQ, S)) < 0.5).astype(
                np.float32)).to(dev))
    init = torch.zeros(S, device=dev)
    init[1] = 1.0
    c0 = torch.from_numpy((rng.random((B, 8, S)) < 0.3).astype(
        np.float32)).to(dev)
    window = wkern.DeviceWindow.time(5.0, max_window_events=8)
    for what, kw in (
            ("per-lane start_pos", dict(start_pos=torch.tensor(
                [3, 0, 9, 1, 0], dtype=torch.int32, device=dev))),
            ("valid_counts", dict(valid_counts=torch.tensor(
                [T, 1, 0, 7, T], device=dev))),
            ("LAST", dict(latest_q=torch.ones(NQ, device=dev))),
            ("CONSUME", dict(consume_sq=torch.ones((NQ, S), device=dev))),
            ("a time window", dict(window=window, event_ts=torch.arange(
                T * B, dtype=torch.float32, device=dev).reshape(T, B)))):
        state = (wkern.init_state(window, B, S, dev) if "window" in kw
                 else c0)
        kw = {"epsilon": 5, **kw} if "window" not in kw else kw
        counters = reset_launches()
        got = ops.cer_pipeline(*args, state, init_mask=init, impl="unfused",
                               **kw)
        launched = read_launches(counters)
        check(launched == {**{name: 0 for name in launched},
                           "fused_scan": 1},
              f"phase 10: unfused with {what} launched {launched}")
        fused = ops.cer_pipeline(*args, state, init_mask=init, impl="fused",
                                 **kw)
        plain = ops.cer_pipeline(*args, state, init_mask=init, impl="ref",
                                 **kw)
        check(same(got, fused) and same(got, plain),
              f"phase 10: unfused with {what} ≡ fused ≡ plain")
        n += 1
    return n


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
    main_res, main_run = phase_main(args.seed)
    phase_host(args.seed)
    phase_time(args.seed)
    phase_last_lanes(args.seed)
    enum_res = phase_enum(args.seed)
    phase_enum_time(args.seed)
    phase_enum_shapes(args.seed)
    unf_res = phase_unfused(args.seed, main_run)
    del main_run
    packed_res = phase_packed(args.seed)
    phase_edges(args.seed)
    nine_res = phase_nine(args.seed)
    wide_res = phase_enum_wide(args.seed)
    unf = unf_res["kernels"]
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
        "library_ms": None,
        "phase9_ms": packed_res["fused_scan_ms"],
        "phase9_n_split": packed_res["fused_scan_n_split"],
        "phase11_ms": nine_res["fused_scan_ms"],
        "phase11_n_split": nine_res["fused_scan_n_split"]}, {
        "name": "arena_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/arena_update.cu",
        "replaces": "src/repro/kernels/arena_update.py:88",
        "launches": enum_res["launches"]["arena_update"],
        "max_abs_err": max(enum_res["max_abs_err"],
                           wide_res["max_abs_err"]),
        "ms": enum_res["kernel_ms_per_chunk"],
        "plain_ms": enum_res["plain_ms_per_chunk"],
        "bound_ms": enum_res["bound_ms"],
        "bound_by": enum_res["bound_by"],
        "library_ms": None,
        "dense_ms": enum_res["dense_kernel_ms_per_chunk"],
        "dense_bound_ms": enum_res["dense_bound_ms"],
        "phase12_ms": wide_res["kernel_ms_per_chunk"],
        "phase12_bound_ms": wide_res["bound_ms"],
        "phase12_launches": wide_res["launches"]["arena_update"]}, {
        "name": "bitvector", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitvector.cu",
        "replaces": "src/repro/kernels/bitvector.py:45",
        "launches": unf_res["feed_launches"]["bitvector"],
        "max_abs_err": unf["bitvector"]["max_abs_err"],
        "ms": unf["bitvector"]["ms"],
        "plain_ms": unf["bitvector"]["plain_ms"],
        "bound_ms": unf["bitvector"]["bound_ms"],
        "bound_by": unf["bitvector"]["bound_by"],
        "library_ms": None}, {
        "name": "cea_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cea_scan.cu",
        "replaces": "src/repro/kernels/cea_scan.py:195",
        "launches": unf_res["classify_scan_launches"]["cea_scan"],
        "max_abs_err": unf["cea_scan"]["max_abs_err"],
        "ms": unf["cea_scan"]["ms"],
        "plain_ms": unf["cea_scan"]["plain_ms"],
        "bound_ms": unf["cea_scan"]["bound_ms"],
        "bound_by": unf["cea_scan"]["bound_by"],
        "library_ms": None}, {
        "name": "cea_scan_multi", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cea_scan.cu",
        "replaces": "src/repro/kernels/cea_scan.py:283",
        "launches": packed_res["launches"]["unfused"]["cea_scan_multi"],
        "max_abs_err": packed_res["max_abs_err"],
        "ms": packed_res["cea_scan_multi_ms"],
        "plain_ms": packed_res["cea_scan_multi_plain_ms"],
        "bound_ms": packed_res["bound_ms"],
        "bound_by": packed_res["bound_by"],
        "library_ms": None,
        "n_split": packed_res["cea_scan_multi_n_split"],
        "phase11_ms": nine_res["cea_scan_multi_ms"],
        "phase11_n_split": nine_res["cea_scan_multi_n_split"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
