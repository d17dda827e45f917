#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with a CUDA device, nvcc and
PyTorch built for CUDA.  It builds the port's kernel library from
``src/repro_torch/kernels/csrc/`` (``fused_scan.cu``, ``arena_update.cu``,
``bitvector.cu``, ``cea_scan.cu`` and ``lane_route.cu``, one nvcc each,
started together), then runs these phases, each printing one JSON line:

0. card: ``nvidia-smi`` name and power limit, versions, library build time,
   the launch floor (an empty kernel, 1000 launches: one Python call per
   launch, and back to back from C);
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
    bound on one more chunk (≡ plain), peak memory, sampled enumeration;
13. PARTITION BY at phase 1's width: phase 1's query partitioned by
    ``uid``, 1024 lanes, 8 chunks of 262 144 interleaved events (keys
    uniform over 1024 uid values plus 2 % NULL), ``lane_cap`` 384, through
    ``PartitionedStreamingEngine.feed_keyed``: one lane_route and one
    fused_scan launch per chunk; chunk 1 allocates every lane, no spill or
    eviction; counts ≡ each key's closed form at its global positions;
    router (chunk 1 and steady state) and fused kernel ≡ plain, times,
    bounds, the feed's steps, peak memory.  Then the same with the arena
    (5.4 GB node store): counts and hits ≡ the run without it, key 0 ≡ the
    host ``Engine`` on its substream, sampled hits enumerate their count,
    the store kernel ≡ plain on one more chunk, its time and bound.  Then
    exactness: 64 lanes, 96 Zipf-skewed keys, ``lane_cap`` 96, chunks of
    4096 with the arena, ``evict="lru"`` and ``"none"`` (evictions,
    capacity and table spills all occur): the router ≡ plain on every
    chunk, the engine ≡ ``impl="ref"`` (counts, hits, stats, every
    snapshot leaf, enumerated sets); and the paper's stock Q3 ``PARTITION
    BY [volume]`` through ``feed(events)`` ≡ plain ≡ the host
    ``PartitionedEngine``;
14. recovery, checkpoints and the ``StreamService`` ingestion loop (in a
    scratch directory under ``build/``, removed afterwards).  14a: the
    service over phase 13's engine (1024 lanes, chunks of 262 144,
    ``lane_cap`` 384), 4 chunks of raw dict events from one producer with
    three malformed ones (the dead-letter queue's three reasons),
    checkpoints every 2 chunks, a sink: one lane_route and one fused_scan
    launch per chunk, one library load; the durable record and the sink ≡
    each key's closed form ≡ a direct ``feed_keyed`` of the same encoded
    chunks; accepted and end-to-end events/s, chunk latency p50/p99, per
    chunk the encode, device step, log append and checkpoint times and
    bytes, the encode/step overlap, ``queue_peak``.  14b: kill -9 on the
    card: a ``RecoveringStreamRunner`` over a 64-lane engine with the
    arena, checkpoints every 4 chunks, is SIGKILLed after chunk 11 in a
    subprocess and resumed in another (chunks 8-10 replay through the
    replay check); then the service's own kill -9 contract (a sink that
    enumerates, SIGKILL after 3 deliveries, restart): records and alerts
    deduplicated by chunk ≡ uninterrupted in-process runs.  14c: overflow
    heal: a time window over a ring of 8 with ``strict_overflow``; the
    service regrows and replays, and ≡ a service sized large from the
    start, every count below 2^24.  14d: the single-stream adapter ≡ its
    engine's direct ``feed_attrs``.

15. the ``QueryFleet`` on the card.  15a: ``QueryFleet(chunk_len=256,
    batch=1024)`` fed phase 9's draws as ``Event``s over 8 chunks, two
    window buckets (phase 9's queries ``WITHIN 3200 events``; two queries
    ``WITHIN 1600``) under churn: adds at chunks 2 and 3, a fifth query at
    chunk 4 (Ŝ 28 → 35: the wide build) removed at 5, a remove and re-add
    under a fresh qid at 6 (a cache hit); every query lifetime ≡ its
    closed form over its suffix on all 1024 lanes; one fused_scan launch
    per bucket per chunk, one library load, ``compile_count`` ≤
    ``distinct_geometries``; per chunk the feed split into encode, device
    step and the rest, per repack its time and bytes, and each bucket's
    kernel (32-state, 16-state and wide) ≡ plain on one chunk after a
    repack with its time and bound.  15b: the fleet with the arena at
    phase 5's width (64 lanes, ``arena_capacity=2**18``), a repack with
    the arena live and a re-add that reuses the cached arena tables: ≡ a
    plain fleet on every chunk (counts, node store, cells, roots, cost
    reports), lane 0 ≡ the host ``Engine``.  15c: the ``StreamService``
    over a batch-1 fleet ≡ a direct ``fleet.feed``; a fleet runner
    SIGKILLed mid-churn in a subprocess (``--fleet-worker``) and resumed ≡
    an uninterrupted run.  15d: 14 live predicates padded to 16 bits and
    eight attribute columns through the fused kernel ≡ a plain fleet.

16. distribution on an NCCL group of world size 1 (``make_production_mesh``
    through a file store in a scratch directory under ``build/``).  16a:
    phase 1's draws through ``sharded_cer_pipeline`` ≡ the unsharded
    ``ops.cer_pipeline`` (counts and ring; one fused_scan launch a chunk)
    and phase 8's class ids through ``sharded_cea_scan`` ≡ ``ops.cea_scan``
    (one cea_scan launch), with their times beside the unsharded calls'.
    16b: phase 13's draws through ``route_partitioned_chunk`` (one
    ``all_to_all``) and ``feed_keyed(positions=)`` ≡ phase 13's unsharded
    feed, fed in turns (counts, hits, state; one lane_route and one
    fused_scan launch a chunk); the router's ms a chunk (bucket sort and
    ``all_to_all`` apart), its bytes, the feed's ms and events/s.  16c: a
    stream whose NULL-keyed events lack the filtered attribute, routed and
    fed ≡ the host ``PartitionedEngine``.  16d: a checkpoint of 16b's
    engine restored onto the card by ``restore_resharded`` ≡ the live
    state.  16e: ``examples/torch_quickstart.py`` and
    ``examples/torch_multi_query.py`` on the card print what they print
    with ``--device cpu``, and the dry run runs on the card.

17. the LM serve path (``repro_torch.launch.serve``'s functions; scratch
    directories under ``build/``).  17a: Qwen2.5-14B at its published
    width (48 layers, d_model 5120, 40 heads, 8 KV heads, head_dim 128,
    d_ff 13824, vocab 152064, bf16; 29.5 GB of weights drawn on the card
    from the seed), 4 lanes, an 8-token prompt, 32 greedy decode steps,
    twice (the first keeps the logits for the checks, the second is
    timed): every logit finite, and decode ≡ ``forward_train`` over the 40
    tokens within bf16's rounding (max |Δ| ≤ √(16·layers)·2⁻⁸·max |logit|:
    16 bf16 roundings a layer, independent errors growing as the square
    root of their count); prefill ms, decode ms a step (median and spread,
    host clock around a synchronize), tokens/s, the step's bound (weights
    but the embedding, the KV cache and the logits, at 3.35 TB/s) and its
    share, peak memory, and 4 steps under ``torch.profiler`` (kernels a
    step, the device's busy time, its idle share).  Then a 4-layer cut of
    the same widths in float32 (10.6 GB), where decode ≡ teacher forcing
    at ``tests/test_archs.py``'s 5e-4.  17b: the guard (``PARTITION BY
    [lane]``) over 17a's 128 token events through the launcher's
    ``--service`` path on the card (one lane_route and one fused_scan
    launch a chunk) ≡ the same service on the CPU ≡ the host
    ``PartitionedEngine``, per position, exactly; both kernels ≡ plain on
    one more chunk, with times and bounds at the guard's shape, and the
    guard's step ms.  17c: ``examples/torch_serve_monitored.py --service``
    and ``python -m repro_torch.launch.serve --arch qwen2.5-14b --smoke
    --service`` on the card exit 0 (the example's asserts hold the card's
    service to the host baseline and its heal to a service sized large
    from the start).

Phase 8 also times ``bitvector`` alone on the device: its launches
queued behind a spin kernel, so host work leaves no gap between them
(CUDA events), beside the host time of one wrapper call.

Then the kernels line and, last, ``{"ok": true, "device": {...}}``.  Every
comparison of kernel and plain version is exact (tolerance 0; phase 17a's
model is no kernel and has the tolerances stated there): counts are
f32 integers, exact below 2^24 in any order of summation, and the script
checks that every count stays below 2^24; the arena's records, roots and
stores are int32 node ids.  Any failure raises, so the exit
code is not 0 and no result line is printed.  Without CUDA, or outside a
checkout, it exits with an error before doing anything.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
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
        if a.dtype == b.dtype == torch.uint32:     # compared as their bits
            a, b = a.view(torch.int32), b.view(torch.int32)
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


def queued_ms(fn, reps: int, spin_cycles: int = 200_000_000):
    """Device time per call of ``fn`` with no host work in it, by CUDA
    events: the calls are queued behind a spin kernel, so the device runs
    their kernels back to back once it ends.  Returns ``(device ms per
    call, host ms per call to enqueue, spin ms)``; the spin must outlast
    the enqueueing, which is checked."""
    fn()
    torch.cuda.synchronize()
    s0, t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    s0.record()
    torch.cuda._sleep(spin_cycles)
    t0.record()
    h0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = 1e3 * (time.perf_counter() - h0)
    t1.record()
    torch.cuda.synchronize()
    spin_ms = s0.elapsed_time(t0)
    check(host_ms < spin_ms, f"queued_ms: enqueueing took {host_ms:.2f} ms, "
          f"longer than the {spin_ms:.2f} ms spin")
    return t0.elapsed_time(t1) / reps, host_ms / reps, spin_ms


def clone_state(state):
    if isinstance(state, dict):
        return {k: v.clone() for k, v in state.items()}
    return state.clone()


# ---------------------------------------------------------------------------


def phase_card():
    from repro_torch.kernels.build import LIBRARY
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lib = LIBRARY.get()
    ptxas = [ln.strip() for ln in LIBRARY.build_log.splitlines()
             if ln.startswith("==") or "registers" in ln or "spill" in ln]
    # the launch floor: an empty kernel, one launch per call from Python
    # (as the wrappers launch), and 1000 launches back to back from C
    lib.empty_launches.restype = ctypes.c_int
    lib.empty_launches.argtypes = [ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    per_call_ms = cuda_ms(lambda: lib.empty_launches(1, stream), reps=1000)
    back_to_back_ms = cuda_ms(lambda: lib.empty_launches(1000, stream),
                              reps=3) / 1000
    emit({"phase": 0, "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "build_s": round(LIBRARY.build_seconds, 3), "ptxas": ptxas,
          "launch_floor_ms": {"one_call_per_launch": per_call_ms,
                              "back_to_back": back_to_back_ms}})
    return smi, per_call_ms


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
    from repro_torch.kernels import fused_scan, lane_route
    counters = {"fused_scan": fused_scan.KERNEL,
                "arena_update": arena_update.KERNEL,
                "arena_update_dense": arena_update.DENSE,
                "bitvector": bitvector.KERNEL,
                "cea_scan": cea_scan.SINGLE,
                "cea_scan_multi": cea_scan.MULTI,
                "lane_route": lane_route.KERNEL}
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
                            "cea_scan_multi": n_chunks, "lane_route": 0},
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
                            "cea_scan_multi": 0, "lane_route": 0},
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
    bv_device, bv_host, bv_spin = queued_ms(
        lambda: ops.bitvector(flat, specs), reps=200)
    res["bitvector"] = {
        "ms": cuda_ms(lambda: ops.bitvector(flat, specs), reps=20),
        "device_ms": bv_device, "host_call_ms": bv_host,
        "spin_ms": bv_spin,
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


# ---------------------------------------------------------------------------
# PARTITION BY: the lane router ahead of the fused-scan and store kernels
# ---------------------------------------------------------------------------

PART_TYPES = ["A1", "A2", "A3"] + [f"B{i}" for i in range(1, 7)]
# the paper's stock Q3 with its PARTITION BY clause (benchmarks/cer_paper.py)
STOCK_Q3_PART = """SELECT * FROM S
    WHERE SELL AS msft ; BUY AS oracle ; BUY AS csco ; SELL AS amat
    FILTER msft[name = 'MSFT'] AND oracle[name = 'ORCL'] AND
    csco[name = 'CSCO'] AND amat[name = 'AMAT']
    PARTITION BY [volume]
    WITHIN 30000 [stock_time]
    CONSUME BY ANY"""


def key_table(n: int) -> np.ndarray:
    """(n + 1,) uint32: the partition hashes of ``user-0`` … and, last,
    the NULL key (index -1)."""
    from repro_torch.core.partition import NULL_KEY_HASH, stable_key_hash
    return np.array([stable_key_hash((f"user-{i}",)) for i in range(n)]
                    + [NULL_KEY_HASH], np.uint32)


def part_draws(seed, L, T, n_chunks):
    """Keys uniform over L uid values plus 2 % NULL (index -1), types
    uniform over phase 1's nine; key 0 draws A1-A3 at 1 % each so that the
    host Engine can enumerate its matches.  Returns (key index, type index,
    uint32 keys), each (n_chunks, T)."""
    rng = np.random.default_rng(seed)
    kidx = rng.integers(0, L, (n_chunks, T))
    kidx[rng.random((n_chunks, T)) < 0.02] = -1
    types = rng.integers(0, len(PART_TYPES), (n_chunks, T))
    rare = kidx == 0
    types[rare] = rng.choice(len(PART_TYPES), int(rare.sum()),
                             p=[0.01] * 3 + [0.97 / 6] * 6)
    return kidx, types, key_table(L)[kidx]


def part_closed_form(kidx, types, L, eps):
    """Counts per global position: the closed form of each key's substream
    (``seq3_counts``), scattered back to the key's global positions."""
    k, ty = kidx.reshape(-1), types.reshape(-1)
    order = np.argsort(k, kind="stable")
    order = order[k[order] >= 0]
    bounds = np.searchsorted(k[order], np.arange(L + 1))
    n_max = int(np.diff(bounds).max())
    sub = np.full((n_max, L), -1, np.int64)
    for b in range(L):
        pos = order[bounds[b]:bounds[b + 1]]
        sub[:len(pos), b] = np.where(ty[pos] < 3, ty[pos], -1)
    counts_sub = seq3_counts(sub, eps)
    out = np.zeros(k.shape[0], np.int64)
    for b in range(L):
        pos = order[bounds[b]:bounds[b + 1]]
        out[pos] = counts_sub[:len(pos), b]
    return out


def part_engine(query, T, L, cap, **kw):
    from repro_torch.vector import PartitionedStreamingEngine, VectorEngine
    return PartitionedStreamingEngine(VectorEngine(query), ("uid",), T, L,
                                      lane_cap=cap, **kw)


def route_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def route_err(a, b) -> float:
    """Largest absolute difference over every field of two LaneRoutes
    (lanes, ranks, flags, lane tables, fills)."""
    return max(max_abs_err(x, y) for x, y in zip(a, b))


def part_feed(eng, chunks, keys):
    """Feed every chunk: (feed seconds, counts, hits, active lanes and the
    lane table after each feed)."""
    feed_s, counts, hits, tables = [], [], [], []
    for attrs, k in zip(chunks, keys):
        t0 = time.perf_counter()
        c, h = eng.feed_keyed(attrs, k)
        feed_s.append(time.perf_counter() - t0)
        counts.append(c)
        hits += h
        tables.append(eng._lane_keys_np().copy())
    return feed_s, np.concatenate(counts), hits, tables


def part_step_operands(eng, attrs, keys_dev):
    """The fused kernel's operands of one more chunk from the engine's
    state, without changing it: the route, the scattered attributes and
    positions (cap, L), each lane's start and fill."""
    from repro_torch.kernels import ops
    from repro_torch.vector.partitioned import _lanes_of, _slots
    st = eng.state
    L, cap = eng.num_lanes, eng.lane_cap
    route = ops.lane_route(keys_dev, st["lane_keys"], st["lane_last"],
                           chunk_idx=eng._chunk_idx, cap=cap)
    check(not bool(route.evicted.any()), "phase 13: the steady state "
          "evicts no lane")
    _, _, slot = _slots(route, L, cap)
    T = attrs.shape[0]
    gpos = eng.position + torch.arange(T, dtype=torch.int32,
                                       device=attrs.device)
    return {"attrs": _lanes_of(attrs, slot, L, cap, 0.0),
            "gpos": _lanes_of(gpos, slot, L, cap, -1),
            "start": st["lane_pos"].clone(), "fill": route.fill}


def part_fused(eng, ops_, state, impl="fused", trace=False):
    from repro_torch.kernels import ops
    t = eng.engine.tables
    return ops.cer_pipeline(
        ops_["attrs"], eng.encoder.specs, t.class_of, t.class_ind, t.m_all,
        t.finals[None, :], state, init_mask=t.init_mask, window=eng.window,
        start_pos=ops_["start"], valid_counts=ops_["fill"], impl=impl,
        return_trace=trace, inplace=True)


def part_fused_bound(eng, ops_):
    """Least seconds of the fused kernel on one partitioned chunk, by bytes
    and by operations: the sparse f32 arithmetic the live steps' classes
    need (non-zeros of M_all[class] and of the finals, per ring slot), and
    the ring in and out, the lanes' attributes and positions and the
    tables read once.  Also returns the (cap, L) mask of live steps."""
    from repro_torch.kernels import ref
    tab = eng.engine.tables
    cap, L, A = ops_["attrs"].shape
    dev = ops_["attrs"].device
    W, S = eng.window.ring, tab.num_states
    idx = torch.tensor([s[0] for s in eng.encoder.specs], device=dev)
    opc = torch.tensor([s[1] for s in eng.encoder.specs], device=dev)
    thr = torch.tensor([s[2] for s in eng.encoder.specs], device=dev)
    cls = ref.class_trace_ref(ops_["attrs"], idx, opc, thr, tab.class_of)
    live = torch.arange(cap, device=dev)[:, None] < ops_["fill"][None, :]
    nnz_m = (tab.m_all != 0).sum(dim=(1, 2))
    flops = 2 * W * (int(nnz_m[cls.long()][live].sum())
                     + int(live.sum()) * int((tab.finals != 0).sum()))
    nbytes = 4 * (2 * L * W * S + cap * L * A + cap * L + 2 * L
                  + tab.m_all.numel() + tab.class_of.numel() + 2 * S)
    return nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S, live


def route_bound(T: int, L: int):
    """Least seconds of the lane router on T keys and L lanes, by bytes
    (keys in; lanes, ranks and flags out; the lane tables in and out) and
    by operations (16 a key); and the bytes."""
    r_bytes = T * (4 + 4 + 4 + 1) + L * (2 * 4 + 3 * 4 + 1)
    return r_bytes / PEAK_BYTES_PER_S, 16 * T / PEAK_F32_FLOP_PER_S, r_bytes


def phase_part(seed: int, L: int = 1024, T: int = 262144, cap: int = 384,
               n_chunks: int = 8) -> dict:
    """PARTITION BY at phase 1's width: 1024 lanes, chunks of 262 144
    interleaved events, lane_cap 384, without and with the arena."""
    from repro_torch.core import compile_query
    from repro_torch.core.engine import Engine
    from repro_torch.core.events import Event
    from repro_torch.core.partition import EMPTY_LANE
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_scan import KERNEL
    t_start = time.perf_counter()
    eps = 3200
    query = MAIN_QUERY.format(eps)
    kidx, types, keys = part_draws(seed + 30, L, T, n_chunks)
    eng = part_engine(query, T, L, cap)
    dev = eng.device
    codes = torch.tensor([eng.encoder.vocab["type"].get(x, -1.0)
                          for x in PART_TYPES], device=dev)
    chunks = [codes[torch.from_numpy(types[i]).to(dev)][:, None].contiguous()
              for i in range(n_chunks)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_launches()
    feed_s, counts, hits, tables = part_feed(eng, chunks, keys)
    launches = read_launches(counters)
    want = {k: 0 for k in launches}
    want.update(lane_route=n_chunks, fused_scan=n_chunks)
    check(launches == want, f"phase 13 launched {launches}, expected one "
          "lane_route and one fused_scan launch per chunk")
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(eng.compile_count == 1, f"compile_count {eng.compile_count}")
    check(int((tables[0] != EMPTY_LANE).sum()) == L and all(
        np.array_equal(t, tables[0]) for t in tables),
        "phase 13: chunk 1 allocates all lanes, later chunks none")
    st = eng.stats
    check(st.spilled_table == st.spilled_capacity == st.evicted_lanes == 0,
          f"phase 13: no spill and no eviction, got {st}")
    closed = part_closed_form(kidx, types, L, eps)
    check(same(counts, closed) and hits == np.nonzero(closed)[0].tolist(),
          "phase 13: counts ≡ each key's closed form at its global "
          "positions")
    check(counts.max() < EXACT_LIMIT, "counts stay below 2^24")

    # the router alone: kernel ≡ plain on chunk 1 (empty table) and in the
    # steady state; times
    keys_dev = ref.key_bits(torch.from_numpy(keys[0])).to(dev)
    empty = torch.full((L,), EMPTY_LANE, dtype=torch.int64,
                       device=dev)
    never = torch.full((L,), -1, dtype=torch.int32, device=dev)
    lk, ll = eng.state["lane_keys"], eng.state["lane_last"]
    router = {}
    for name, table, last in (("chunk1", empty, never),
                              ("steady", lk, ll)):
        def call(impl="fused", table=table, last=last):
            return ops.lane_route(keys_dev, table, last,
                                  chunk_idx=n_chunks, cap=cap, impl=impl)
        got = call()
        plain, s_plain = host_clock(lambda: call("ref"))
        check(route_equal(got, plain), f"phase 13: lane_route kernel ≡ "
              f"plain ({name})")
        router[name] = {"ms": cuda_ms(call, reps=20),
                        "plain_ms": 1e3 * s_plain,
                        "max_abs_err": route_err(got, plain)}
    r_tb, r_to, r_bytes = route_bound(T, L)

    # the fused kernel alone on one more chunk: ≡ plain, time and bound
    ops_ = part_step_operands(eng, chunks[0], keys_dev)
    m_k, c_k = part_fused(eng, ops_, clone_state(eng.state["C"]))
    plan = KERNEL.last_plan
    m_p, c_p = part_fused(eng, ops_, clone_state(eng.state["C"]), "ref")
    check(same(m_k, m_p) and same(c_k, c_p), "phase 13: fused_scan ≡ plain "
          "at per-lane starts and fills")
    err = max(max_abs_err(m_k, m_p), max_abs_err(c_k, c_p))
    del c_k, c_p, m_p
    st_t = clone_state(eng.state["C"])
    fused_ms = cuda_ms(lambda: part_fused(eng, ops_, st_t), reps=5)
    fused_plain_ms = cuda_ms(lambda: part_fused(eng, ops_, st_t, "ref"),
                             reps=1)
    del st_t
    f_tb, f_to, live = part_fused_bound(eng, ops_)
    W, S = eng.window.ring, eng.engine.tables.num_states

    # where one feed's time goes: the device step, then the host side
    (counts_f, _, _, stats_t), s_step = host_clock(
        lambda: eng._step(chunks[0], keys_dev, None, None))
    stats_np, s_stats = host_clock(lambda: stats_t.cpu().numpy())
    cnt, s_counts = host_clock(
        lambda: counts_f.cpu().numpy().astype(np.int64))
    hit_list, s_hits = host_clock(
        lambda: (np.nonzero(cnt.sum(axis=-1))[0]).tolist())
    del counts_f, cnt

    feed_med = float(np.median(feed_s))
    result = {
        "phase": 13, "case": "PARTITION BY at phase 1's width",
        "query": query, "key": "uid", "lanes": L, "T": T, "lane_cap": cap,
        "chunks": n_chunks, "W": W, "S": S,
        "ring_MB": L * W * S * 4 / 1e6, "launches": launches,
        "compile_count": eng.compile_count, "stats": vars(st),
        "matches": int(counts.sum()), "hits": len(hits),
        "feed_ms_per_chunk_median": 1e3 * feed_med,
        "feed_ms_per_chunk": [1e3 * x for x in feed_s],
        "events_per_s": T / feed_med,
        "lane_route_ms": router["steady"]["ms"],
        "lane_route_ms_chunk1": router["chunk1"]["ms"],
        "lane_route_plain_ms": router["steady"]["plain_ms"],
        "lane_route_plain_ms_chunk1": router["chunk1"]["plain_ms"],
        "lane_route_bound_ms": 1e3 * max(r_tb, r_to),
        "lane_route_bound_by": "bytes" if r_tb >= r_to else "operations",
        "lane_route_bound_bytes": r_bytes,
        "lane_route_max_abs_err": max(r["max_abs_err"]
                                      for r in router.values()),
        "fused_scan_ms": fused_ms, "fused_scan_plain_ms": fused_plain_ms,
        "fused_scan_use_smem": plan[0], "fused_scan_n_split": plan[1],
        "fused_scan_bound_ms": 1e3 * max(f_tb, f_to),
        "fused_scan_bound_by": "bytes" if f_tb >= f_to else "operations",
        "live_steps": int(live.sum()), "padded_steps": cap * L,
        "feed_steps_ms": {"device_step": 1e3 * s_step,
                          "stats_to_host": 1e3 * s_stats,
                          "counts_to_host": 1e3 * s_counts,
                          "hit_list": 1e3 * s_hits,
                          "hits": len(hit_list)},
        "host_side_ms": 1e3 * (s_stats + s_counts + s_hits),
        "peak_mem_GB": peak, "max_abs_err": err,
        "seconds": time.perf_counter() - t_start}
    del eng, ops_, m_k
    torch.cuda.empty_cache()

    # the same configuration with the arena (5.4 GB node store)
    t_start = time.perf_counter()
    arena_cap = 1 << 18
    eng = part_engine(query, T, L, cap, arena_capacity=arena_cap)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_launches()
    feed_a, counts_a, hits_a, _ = part_feed(eng, chunks, keys)
    launches_a = read_launches(counters)
    want.update(arena_update=n_chunks)
    check(launches_a == want, f"phase 13 arena launched {launches_a}, "
          "expected one lane_route, fused_scan and arena_update launch per "
          "chunk")
    peak_a = torch.cuda.max_memory_allocated() / 1e9
    check(same(counts_a, counts) and hits_a == hits, "phase 13 arena: "
          "counts and hits ≡ the run without the arena")
    arena = eng.state["arena"]
    check(not bool(arena["ovf"].any()), "phase 13 arena: ovf stays clear")

    # key 0's substream against the host Engine, at global positions
    t_key0 = time.perf_counter()
    flat_k, flat_t = kidx.reshape(-1), types.reshape(-1)
    pos0 = np.nonzero(flat_k == 0)[0]
    compiled = compile_query(query)
    host = Engine(compiled.cea, window=compiled.query.window)
    want_sets = {}
    for j, p in enumerate(pos0):
        ces = host.process(Event(PART_TYPES[flat_t[p]], {}, position=j,
                                 timestamp=float(j)))
        if ces:
            want_sets[int(p)] = {(int(pos0[c.start]), int(pos0[c.end]),
                                  tuple(int(pos0[d]) for d in c.data))
                                 for c in ces}
    hits0 = [h for h in hits_a if flat_k[h] == 0]
    got_sets = {p: {(c.start, c.end, c.data) for c in ces}
                for p, ces in eng.enumerate_hits(hits0).items()}
    check(got_sets == want_sets, "phase 13 arena: key 0 enumerates what "
          "the host Engine finds on its substream")
    n0 = sum(map(len, want_sets.values()))
    s_key0 = time.perf_counter() - t_key0
    sample = [h for h in hits_a if T <= h < 2 * T and flat_k[h] > 0][:32]
    res, s_enum = host_clock(lambda: eng.enumerate_hits(sample))
    for p, ces in res.items():
        check(len(ces) == counts_a[p], f"phase 13 arena: hit {p} "
              f"enumerates {len(ces)} of {counts_a[p]} matches")
    store, s_store = host_clock(
        lambda: part_arena_chunk(eng, chunks[0], keys_dev))
    feed_med_a = float(np.median(feed_a))
    arena_res = {
        "phase": 13, "case": "PARTITION BY at phase 1's width, arena",
        "arena_capacity": arena_cap,
        "store_GB": 5 * L * (arena_cap + 1) * 4 / 1e9,
        "launches": launches_a, "matches": int(counts_a.sum()),
        "max_ptr": int(arena["ptr"].max()), "key0_complex_events": n0,
        "feed_ms_per_chunk_median": 1e3 * feed_med_a,
        "feed_ms_per_chunk": [1e3 * x for x in feed_a],
        "events_per_s": T / feed_med_a,
        "enum_hits": len(sample), "enum_ms": 1e3 * s_enum,
        "key0_check_s": s_key0, "store_check_s": s_store,
        "peak_mem_GB": peak_a, **store,
        "seconds": time.perf_counter() - t_start}
    emit(result)
    emit(arena_res)
    del eng
    torch.cuda.empty_cache()
    return result, arena_res


def part_arena_chunk(eng, attrs, keys_dev) -> dict:
    """One more chunk of the arena engine from its state, which stays as
    it is: the store kernel ≡ its plain version (node store, cells,
    pointers, latches, roots) at per-lane starts, fills and global labels;
    the kernel's time and bound."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.arena_update import KERNEL as AKERNEL
    from repro_torch.vector import tecs_arena
    L, cap = eng.num_lanes, eng.lane_cap
    ops_ = part_step_operands(eng, attrs, keys_dev)
    m_f, _, trace = part_fused(eng, ops_, clone_state(eng.state["C"]),
                               trace=True)
    hits = (m_f > 0.5)[..., :1]
    at = eng.engine.arena_tables()
    saved = eng.state["arena"]
    lay = tecs_arena._block_layout(at, eng.window.ring, eng.epsilon,
                                   eng.arena_capacity)
    kw = dict(lay=lay, ptab=tecs_arena._ptab(at, eng.device),
              finals_sq=tecs_arena._finals(at, eng.device))
    args = (trace, hits, ops_["gpos"], ops_["start"], ops_["fill"])
    ar = {k: v.clone() for k, v in saved.items()}
    roots = ops.arena_store_update(ar, *tecs_arena.chunk_cells(ar), *args,
                                   impl="fused", **kw)
    ar_p = {k: v.clone() for k, v in saved.items()}
    # the plain version runs once (about 8 s at this width): its time is
    # this run's, host clock
    roots_p, s_plain = host_clock(lambda: ops.arena_store_update(
        ar_p, *tecs_arena.chunk_cells(ar_p), *args, impl="ref", **kw))
    err = max_abs_err(roots, roots_p)
    for k in ar:
        check(torch.equal(ar[k], ar_p[k]), f"phase 13 arena: store kernel "
              f"≡ plain on one chunk ({k})")
        err = max(err, max_abs_err(ar[k], ar_p[k]))
    check(torch.equal(roots, roots_p), "phase 13 arena: store roots ≡ plain")
    del ar_p, roots_p
    nodes = int((ar["ptr"] - saved["ptr"]).sum())
    occ = [int((c != -1).any(dim=2).sum()) for c in (saved["cell"],
                                                     ar["cell"])]
    live = int(ops_["fill"].sum())
    folded = live * (sum(occ) / 2 / L + 1)

    def restore():
        for k, v in saved.items():
            ar[k].copy_(v)
        return tecs_arena.chunk_cells(ar)
    c0, _ = restore()
    xs, _ = ref.segment_operands(c0, trace, hits, ops_["start"],
                                 ops_["fill"], lay=lay, n_seg=1)
    fin_np = kw["finals_sq"].cpu().numpy()
    ms = timed_ms(restore, lambda c0, s0: AKERNEL(
        ar, c0, s0, xs[:4], ops_["gpos"], lay=lay, ptab=kw["ptab"],
        finals_sq=fin_np), reps=3)
    bound = arena_bound(nodes, L, cap, eng.window.ring, at.num_states,
                        at.max_indegree, 1, folded)
    del ar
    return {"store_kernel_ms": ms, "store_plain_ms": 1e3 * s_plain,
            "store_bound_ms": bound[0], "store_bound_by": bound[1],
            "store_bound_bytes": bound[2], "nodes_allocated": nodes,
            "folded_slot_steps": folded, "max_abs_err": err}


def zipf_keys(rng, table, T, null_share=0.02):
    """(T,) uint32 keys drawn Zipf-skewed over ``table[:-1]``, with NULL
    keys (``table[-1]``) mixed in."""
    n = len(table) - 1
    w = 1.0 / np.arange(1, n + 1)
    idx = rng.choice(n, T, p=w / w.sum())
    idx[rng.random(T) < null_share] = -1
    return table[idx]


def phase_part_exact(seed: int) -> dict:
    """Churn (evictions, capacity and table spills) with the arena, LRU and
    no eviction: the router kernel ≡ plain on every chunk, the engine with
    kernels ≡ impl="ref"; then the paper's stock Q3 PARTITION BY [volume]
    through feed(events) ≡ plain ≡ the host PartitionedEngine."""
    from repro_torch.core import compile_query
    from repro_torch.core.engine import Engine
    from repro_torch.core.partition import PartitionedEngine
    from repro_torch.data import stock_stream
    from repro_torch.kernels import ops, ref
    from repro_torch.vector import PartitionedStreamingEngine, VectorEngine
    t_start = time.perf_counter()
    L, n_keys, cap, T, n_chunks = 64, 96, 96, 4096, 6
    query = MAIN_QUERY.format(300)
    table = key_table(n_keys)
    out = {"phase": 13, "case": "exactness: churn and stock Q3",
           "churn": {}}
    route_errs = []
    for evict in ("lru", "none"):
        t_churn = time.perf_counter()
        rng = np.random.default_rng(seed + 40)
        kern = part_engine(query, T, L, cap, evict=evict,
                           arena_capacity=1 << 17)
        plain = PartitionedStreamingEngine(
            VectorEngine(query, impl="ref"), ("uid",), T, L, lane_cap=cap,
            evict=evict, arena_capacity=1 << 17)
        codes = torch.tensor([kern.encoder.vocab["type"].get(x, -1.0)
                              for x in PART_TYPES], device=kern.device)
        hits = []
        for _ in range(n_chunks):
            keys = zipf_keys(rng, table, T)
            attrs = codes[torch.from_numpy(rng.integers(
                0, len(PART_TYPES), T)).to(kern.device)][:, None]
            st = kern.state
            args = (ref.key_bits(torch.from_numpy(keys)).to(kern.device),
                    st["lane_keys"].clone(), st["lane_last"].clone())
            kw = dict(chunk_idx=kern._chunk_idx, cap=cap, evict=evict)
            got = ops.lane_route(*args, **kw)
            want = ops.lane_route(*args, impl="ref", **kw)
            check(route_equal(got, want),
                  f"phase 13 churn {evict}: lane_route kernel ≡ plain")
            route_errs.append(route_err(got, want))
            ck, hk = kern.feed_keyed(attrs, keys)
            cp, hp = plain.feed_keyed(attrs, keys)
            check(same(ck, cp) and hk == hp, f"phase 13 churn {evict}: "
                  "counts and hits kernel ≡ plain")
            hits += hk
        sk, sp = kern.snapshot(), plain.snapshot()
        check(sk["meta"] == sp["meta"] and sk["arrays"].keys() ==
              sp["arrays"].keys() and all(
                  same(sk["arrays"][k], sp["arrays"][k])
                  for k in sp["arrays"]), f"phase 13 churn {evict}: "
              "lane tables, rings, node stores, pointers and roots ≡ plain")
        s = kern.stats
        check(s.spilled_capacity > 0 and s.spilled_table > 0 and
              (s.evicted_lanes > 0) == (evict == "lru"),
              f"phase 13 churn {evict}: spills (and evictions) occur, {s}")
        check(not bool(kern.state["arena"]["ovf"].any()),
              f"phase 13 churn {evict}: arena ovf stays clear")
        sample = hits[-16:]
        check({p: sorted((c.start, c.end, c.data) for c in v)
               for p, v in kern.enumerate_hits(sample).items()} ==
              {p: sorted((c.start, c.end, c.data) for c in v)
               for p, v in plain.enumerate_hits(sample).items()},
              f"phase 13 churn {evict}: enumerated sets ≡ plain")
        out["churn"][evict] = {"stats": vars(s), "hits": len(hits),
                               "seconds": time.perf_counter() - t_churn}
        del kern, plain

    # the paper's own PARTITION BY query: stock Q3, 4 volumes on 8 lanes
    t_q3 = time.perf_counter()
    mwe, chunk, n_q3 = 4096, 2048, 4
    stream = stock_stream(chunk * n_q3, seed=seed + 41,
                          events_per_sec=400.0)
    engines = [PartitionedStreamingEngine(
        VectorEngine(STOCK_Q3_PART, max_window_events=mwe, impl=impl),
        ("volume",), chunk, 8) for impl in (None, "ref")]
    got = [[], []]
    for i in range(n_q3):
        part = stream[i * chunk:(i + 1) * chunk]
        for e, g in zip(engines, got):
            g.append(e.feed(part)[0])
    got = [np.concatenate(g) for g in got]
    sk, sp = engines[0].snapshot(), engines[1].snapshot()
    check(same(got[0], got[1]) and all(
        same(sk["arrays"][k], sp["arrays"][k]) for k in sp["arrays"]),
        "phase 13 stock Q3: counts and state kernel ≡ plain")
    check(not engines[0].window_overflow.any() and
          engines[0].num_active_lanes == 4,
          "phase 13 stock Q3: four volumes, ovf clear")
    compiled = compile_query(STOCK_Q3_PART)
    host = PartitionedEngine(
        lambda: Engine(compiled.cea, window=compiled.query.window,
                       consume_on_match=True), ("volume",))
    want = np.array([len(host.process(ev)) for ev in stream], np.int64)
    check(same(got[0], want), "phase 13 stock Q3: counts ≡ the host "
          "PartitionedEngine")
    out["stock_q3"] = {"events": len(stream), "lanes": 8,
                       "ring": engines[0].window.ring,
                       "matches": int(want.sum()),
                       "seconds": time.perf_counter() - t_q3}
    out["router_checks"] = len(route_errs)
    out["lane_route_max_abs_err"] = max(route_errs)
    out["seconds"] = time.perf_counter() - t_start
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 14: recovery, checkpoints and the StreamService ingestion loop
# ---------------------------------------------------------------------------

# three malformed events, spread through the stream (as
# examples/serve_monitored.py injects them), and the reasons they get
SERVICE_JUNK = [{"type": "NOPE", "uid": "user-0"}, "not-an-event",
                {"type": "A1", "uid": "user-0", "x": [1, 2]}]
SERVICE_JUNK_REASONS = ["unknown_type", "not_a_dict", "bad_attr_value"]
# 14b-d: 64 lanes, chunks of 4096 interleaved events (64 a lane)
SMALL_L, SMALL_T, SMALL_CAP = 64, 4096, 128
CRASH_CHUNKS, CRASH_AFTER, CRASH_EVERY = 16, 11, 4
HEAL_QUERY = "SELECT * FROM S WHERE A1 ; A2 ; A3 WITHIN 2000 [t]"


def raw_events(kidx, types, times=None) -> list:
    """Raw dict events of the draws: ``{"type", "uid": "user-k"}``, no
    ``uid`` for NULL keys; ``times`` adds ``"t"``."""
    out = []
    for i, (k, ty) in enumerate(zip(kidx.reshape(-1).tolist(),
                                    types.reshape(-1).tolist())):
        ev = {"type": PART_TYPES[ty]}
        if k >= 0:
            ev["uid"] = f"user-{k}"
        if times is not None:
            ev["t"] = float(times[i])
        out.append(ev)
    return out


def with_junk(raws: list) -> list:
    feed = list(raws)
    for j, bad in enumerate(SERVICE_JUNK):
        feed.insert(len(feed) // 2 + j * 3, bad)
    return feed


def log_counts(cum: dict, T: int) -> np.ndarray:
    """Per global position counts of a durable record of one stream
    (``counts`` keys are ``(chunk, t[, stream])``)."""
    out = np.zeros(max((k[0] + 1) * T for k in cum["counts"]), np.int64)
    for (c, t, *_), v in cum["counts"].items():
        out[c * T + t] = v
    return out


def cumulative_of(counts_per_chunk) -> dict:
    """The durable-record form (``MatchLog.cumulative``) of one direct run
    of a partitioned engine: ``counts`` ``{(chunk, t): v}`` and sorted hit
    positions."""
    counts, hits = {}, []
    for c, (cnt, h) in enumerate(counts_per_chunk):
        for t in np.nonzero(cnt)[0].tolist():
            counts[(c, t)] = int(cnt[t])
        hits += h
    return {"hits": sorted(hits), "counts": counts}


def overlap_s(a, b) -> float:
    """Seconds during which a span of ``a`` and a span of ``b`` both run
    (each list's spans come from one thread and do not overlap)."""
    return sum(max(0.0, min(x1, y1) - max(x0, y0))
               for x0, x1 in a for y0, y1 in b)


def instrument(svc, eng):
    """Host-clock spans of the service's steps, per chunk: the adapter's
    encode (encoder thread), the engine's feed (device thread, ends in the
    copy of the counts to the host), the emission-log append, the
    checkpoint call (engine snapshot to the host and the hand-off) and the
    background write (with its bytes).  Also keeps each encoded chunk."""
    spans = {k: [] for k in ("encode", "step", "log", "checkpoint",
                             "write")}
    encoded, ckpt_bytes = [], []

    def wrap(obj, name, key, keep=None):
        fn = getattr(obj, name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            spans[key].append((t0, time.perf_counter()))
            if keep is not None:
                keep(a, out)
            return out
        setattr(obj, name, timed)

    wrap(svc.adapter, "encode", "encode",
         keep=lambda a, out: encoded.append(out))
    wrap(eng, svc.adapter.feed_method, "step")
    wrap(svc.runner.log, "append", "log")
    wrap(svc.runner, "checkpoint", "checkpoint")
    wrap(svc.runner.manager, "_write", "write",
         keep=lambda a, out: ckpt_bytes.append(
             sum(arr.nbytes for _, arr in a[1])))
    return spans, encoded, ckpt_bytes


def ms_list(spans) -> list:
    return [1e3 * (b - a) for a, b in spans]


def run_service(eng, directory, raws, **kw):
    """Submit every raw event from one producer (``block=True``), drain,
    close.  Returns ``(service, receipts, alerts, seconds of the submit
    loop, seconds to the end of the drain, instrumentation)``."""
    from repro_torch.runtime import StreamService
    alerts = []
    svc = StreamService(eng, str(directory),
                        sinks=[lambda c, h: alerts.append((c, list(h)))],
                        **kw)
    inst = instrument(svc, eng)
    t0 = time.perf_counter()
    receipts = [svc.submit(r, block=True, timeout=600.0) for r in raws]
    t_sub = time.perf_counter() - t0
    svc.drain(pad=True, timeout=600.0)
    t_end = time.perf_counter() - t0
    svc.close()
    return svc, receipts, alerts, t_sub, t_end, inst


def phase_service(seed: int, work: Path, L: int = 1024, T: int = 262144,
                  cap: int = 384, n_chunks: int = 4) -> dict:
    """14a: the StreamService over phase 13's engine at full width: raw
    dict events from one producer, validation and the dead-letter queue,
    checkpoints every 2 chunks, a sink; the durable record and the sink ≡
    each key's closed form ≡ a direct feed_keyed run of the same chunks."""
    from repro_torch.kernels.build import LIBRARY
    from repro_torch.runtime import EventValidator, cumulative_matches
    t_start = time.perf_counter()
    eps = 3200
    query = MAIN_QUERY.format(eps)
    kidx, types, keys = part_draws(seed + 50, L, T, n_chunks)
    feed = with_junk(raw_events(kidx, types))
    eng = part_engine(query, T, L, cap)
    dev = eng.device
    d = work / "service"
    loads = LIBRARY.loads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_launches()
    svc, receipts, alerts, t_sub, t_end, (spans, encoded, ckpt_bytes) = \
        run_service(eng, d, feed, checkpoint_every=2,
                    validator=EventValidator(allowed_types=PART_TYPES))
    launches = read_launches(counters)
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {k: 0 for k in launches}
    want.update(lane_route=n_chunks, fused_scan=n_chunks)
    check(launches == want, f"phase 14a launched {launches}, expected one "
          "lane_route and one fused_scan launch per chunk")
    check(LIBRARY.loads == loads == 1 and eng.compile_count == 1,
          f"phase 14a: one library load ({LIBRARY.loads})")
    m = svc.metrics
    rejected = [r for r in receipts if r.status == "rejected"]
    check([r.reason for r in rejected] == SERVICE_JUNK_REASONS and
          [r["reason"] for r in svc.dlq.records] == SERVICE_JUNK_REASONS,
          f"phase 14a: the dead-letter queue holds the three malformed "
          f"events, got {[r.reason for r in rejected]}")
    check(m.accepted == n_chunks * T and m.chunks == n_chunks and
          m.rejected == 3 and m.events_processed == n_chunks * T,
          f"phase 14a: accepted {m.accepted}, chunks {m.chunks}")
    # the encoder's operands are the draws' codes and key hashes
    codes = np.array([eng.encoder.vocab["type"].get(x, -1.0)
                      for x in PART_TYPES], np.float32)
    check(len(encoded) == n_chunks and all(
        same(a.numpy()[:, 0], codes[types[i]]) and
        same(k.numpy().view(np.uint32), keys[i])
        for i, ((a, k), _) in enumerate(encoded)),
        "phase 14a: the encoded chunks hold the draws' codes and keys")
    cum = cumulative_matches(str(d))
    closed = part_closed_form(kidx, types, L, eps)
    check(same(log_counts(cum, T), closed[:len(log_counts(cum, T))]) and
          cum["hits"] == np.nonzero(closed)[0].tolist(),
          "phase 14a: the durable record ≡ each key's closed form")
    check(max(cum["counts"].values()) < EXACT_LIMIT,
          "phase 14a: counts stay below 2^24")
    check(sorted(h for _, hs in alerts for h in hs) == cum["hits"] and
          [c for c, _ in alerts] == sorted({c for c, _ in cum["counts"]}),
          "phase 14a: the sink received every chunk's hits once")
    # the same encoded chunks fed directly, each step timed alone (no
    # producer or encoder thread holding the interpreter lock)
    direct = part_engine(query, T, L, cap)
    runs, direct_s = [], []
    for (a, k), _ in encoded:
        out, s = host_clock(lambda: direct.feed_keyed(a.to(dev), k.to(dev)))
        runs.append(out)
        direct_s.append(s)
    check(cumulative_of(runs) == cum, "phase 14a: the durable record ≡ a "
          "direct feed_keyed run of the same encoded chunks")
    del direct, runs, encoded
    ckpt_steps = [int(p.name.split("_")[1])
                  for p in (d / "ckpt").iterdir() if p.is_dir()]
    overlap = overlap_s(spans["encode"], spans["step"])
    result = {
        "phase": 14, "case": "a: StreamService at phase 13's width",
        "query": query, "lanes": L, "T": T, "lane_cap": cap,
        "chunks": n_chunks, "events_submitted": len(feed),
        "launches": launches, "compile_count": eng.compile_count,
        "counters": {k: v for k, v in vars(m).items()
                     if k != "chunk_latency_s"},
        "dlq_reasons": [r["reason"] for r in svc.dlq.records],
        "matches": int(sum(cum["counts"].values())),
        "hits": len(cum["hits"]), "alert_chunks": len(alerts),
        "accepted_events_per_s": m.accepted / t_sub,
        "end_to_end_events_per_s": m.accepted / t_end,
        "submit_s": t_sub, "end_to_end_s": t_end,
        "chunk_latency_s": m.latency_percentiles(),
        "encode_ms": ms_list(spans["encode"]),
        "device_step_ms": ms_list(spans["step"]),
        "direct_step_ms": [1e3 * s for s in direct_s],
        "log_append_ms": ms_list(spans["log"]),
        "checkpoint_call_ms": ms_list(spans["checkpoint"]),
        "checkpoint_write_ms": ms_list(spans["write"]),
        "checkpoint_bytes": ckpt_bytes, "checkpoint_steps": ckpt_steps,
        "encode_step_overlap_s": overlap,
        "queue_peak": m.queue_peak, "peak_mem_GB": peak,
        "seconds": time.perf_counter() - t_start}
    emit(result)
    del eng, svc
    torch.cuda.empty_cache()
    return result


def crash_draws(seed):
    """14b's stream: 64 lanes' keys and phase 13's type draws, 16 chunks
    of 4096 (key index, type index, uint32 keys)."""
    return part_draws(seed + 60, SMALL_L, SMALL_T, CRASH_CHUNKS)


def crash_engine():
    return part_engine(MAIN_QUERY.format(3200), SMALL_T, SMALL_L, SMALL_CAP,
                       arena_capacity=1 << 18)


def crash_run(directory, crash_after: int, seed: int) -> dict:
    """The crash-recovery worker: a RecoveringStreamRunner over the arena
    engine, checkpoints every 4 chunks; SIGKILLs itself once
    ``crash_after`` chunks are fed (-1: never)."""
    from repro_torch.runtime import RecoveringStreamRunner
    _, types, keys = crash_draws(seed)
    eng = crash_engine()
    codes = torch.tensor([eng.encoder.vocab["type"].get(x, -1.0)
                          for x in PART_TYPES], device=eng.device)
    runner = RecoveringStreamRunner(eng, str(directory), every=CRASH_EVERY,
                                    feed_method="feed_keyed")
    resumed = runner.chunk_index if runner.resume() else None
    replayed = 0
    for i in range(runner.chunk_index, CRASH_CHUNKS):
        attrs = codes[torch.from_numpy(types[i]).to(eng.device)][:, None]
        _, _, emitted = runner.process(attrs, keys[i])   # replays checked
        replayed += not emitted
        if runner.chunk_index == crash_after:
            print(json.dumps({"killed_after": crash_after}), flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
    runner.close()
    return {"resumed_at": resumed, "replayed": replayed,
            "max_ptr": int(eng.state["arena"]["ptr"].max()),
            "arena_ovf": bool(eng.state["arena"]["ovf"].any())}


def service_kill_run(directory, crash_after: int, seed: int) -> dict:
    """The service's kill -9 contract on the card: a StreamService over
    the 64-lane arena engine, checkpoints every 2 chunks, a sink that
    enumerates each chunk's first hit and appends ``{chunk, hits,
    n_complex}`` durably; SIGKILL after ``crash_after`` deliveries."""
    from repro_torch.runtime import StreamService
    kidx, types, _ = crash_draws(seed + 1)
    raws = raw_events(kidx[:12], types[:12])
    eng = crash_engine()
    path = Path(directory) / "alerts.jsonl"
    n = [0]

    def sink(chunk, hits):
        n_ces = len(eng.enumerate(hits[0]))
        with open(path, "a") as f:
            f.write(json.dumps({"chunk": chunk, "hits": hits,
                                "n_complex": n_ces}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        n[0] += 1
        if 0 <= crash_after <= n[0]:
            os.kill(os.getpid(), signal.SIGKILL)    # kill -9 mid-chunk
    svc = StreamService(eng, str(directory), sinks=[sink],
                        checkpoint_every=2)
    for r in raws:
        svc.submit(r, block=True, timeout=600.0)
    svc.drain(pad=True, timeout=600.0)
    svc.close()
    return {"chunks": svc.metrics.chunks,
            "skipped": svc.metrics.skipped_chunks,
            "replayed": svc.metrics.replayed_chunks}


def worker(args: list, timeout: float = 600.0):
    """Run chip_smoke.py in one of its worker modes; (rc, last JSON line
    of its output or None, stderr's tail)."""
    p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")]
                       + args, capture_output=True, text=True,
                       timeout=timeout)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    return p.returncode, (json.loads(lines[-1]) if lines else None), \
        p.stderr[-2000:]


def delivered(path: Path) -> tuple:
    """Alerts deduplicated by chunk (a redelivered chunk must carry the
    same hits), with the first delivery's enumerated count; and the
    redeliveries, ``[chunk, complex events at the first delivery, at
    the redelivery]``.  A redelivery after a restart reaches the sinks
    before the replay that rebuilds its roots, so only the first delivery
    of a chunk past the checkpoint can enumerate."""
    out, redelivered = {}, []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        c = rec.pop("chunk")
        if c in out:
            redelivered.append([c, out[c]["n_complex"], rec["n_complex"]])
            check(out[c]["hits"] == rec["hits"], f"phase 14b: chunk {c} "
                  "redelivered with other hits")
        else:
            out[c] = rec
    return out, redelivered


def phase_kill9(seed: int, work: Path) -> dict:
    """14b: kill -9 on the card, the runner and the service.  Each crash
    and restart is a subprocess over the same directory; the durable
    record equals an uninterrupted in-process run."""
    from repro_torch.runtime import cumulative_matches
    t_start = time.perf_counter()
    out = {"phase": 14, "case": "b: kill -9 and restart on the card",
           "lanes": SMALL_L, "T": SMALL_T, "arena_capacity": 1 << 18}

    # the runner: oracle in-process, then crash + restart
    counters = reset_launches()
    oracle = crash_run(work / "runner_ref", -1, seed)
    out["launches"] = read_launches(counters)
    want = {k: 0 for k in out["launches"]}
    want.update(lane_route=CRASH_CHUNKS, fused_scan=CRASH_CHUNKS,
                arena_update=CRASH_CHUNKS)
    check(out["launches"] == want, f"phase 14b launched "
          f"{out['launches']}, expected one router, fused and store launch "
          "per chunk")
    check(not oracle["arena_ovf"], "phase 14b: arena ovf stays clear")
    d = work / "runner_crash"
    rc, first, err = worker(["--crash-worker", str(d), "--crash-after",
                             str(CRASH_AFTER), "--seed", str(seed)])
    check(rc == -signal.SIGKILL and first == {"killed_after": CRASH_AFTER},
          f"phase 14b: the runner worker dies by SIGKILL, rc={rc}: {err}")
    rc, second, err = worker(["--crash-worker", str(d), "--seed",
                              str(seed)])
    check(rc == 0 and second["resumed_at"] == 8 and
          second["replayed"] == CRASH_AFTER - 8,
          f"phase 14b: the restart resumes at chunk 8 and replays chunks "
          f"8-10 through the replay check, rc={rc} {second}: {err}")
    want_cum = cumulative_matches(str(work / "runner_ref"))
    check(want_cum["hits"] and cumulative_matches(str(d)) == want_cum,
          "phase 14b: the runner's record after kill -9 ≡ the "
          "uninterrupted run")
    out["runner"] = {"oracle": oracle, "restart": second,
                     "hits": len(want_cum["hits"]),
                     "matches": int(sum(want_cum["counts"].values()))}

    # the service's own contract: alerts deduplicated by chunk
    ref_dir = work / "service_ref"
    ref_dir.mkdir()
    service_kill_run(ref_dir, -1, seed)
    d = work / "service_crash"
    d.mkdir()
    rc, _, err = worker(["--service-worker", str(d), "--crash-after", "3",
                         "--seed", str(seed)])
    check(rc == -signal.SIGKILL, f"phase 14b: the service worker dies by "
          f"SIGKILL, rc={rc}: {err}")
    rc, second, err = worker(["--service-worker", str(d), "--seed",
                              str(seed)])
    # every chunk the killed run logged (at least the 3 delivered) is
    # inside the restored checkpoint or replays under the high-water mark;
    # the async checkpoint of chunk 2 may not have published before the kill
    check(rc == 0 and second["skipped"] + second["replayed"] >= 3,
          f"phase 14b: the restarted service skips or replays what the "
          f"killed run logged, rc={rc} {second}: {err}")
    want_cum = cumulative_matches(str(ref_dir))
    check(want_cum["hits"] and cumulative_matches(str(d)) == want_cum,
          "phase 14b: the service's record after kill -9 ≡ the "
          "uninterrupted run")
    (got, redelivered), (ref_alerts, ref_re) = \
        delivered(d / "alerts.jsonl"), delivered(ref_dir / "alerts.jsonl")
    check(got == ref_alerts and not ref_re, "phase 14b: alerts "
          "deduplicated by chunk, enumerated counts included, ≡ the "
          "uninterrupted run")
    out["service"] = {"restart": second, "alert_chunks": len(got),
                      "redelivered": redelivered,
                      "complex_events": sum(r["n_complex"]
                                            for r in got.values()),
                      "hits": len(want_cum["hits"])}
    out["seconds"] = time.perf_counter() - t_start
    emit(out)
    return out


def phase_heal(seed: int, work: Path, n_chunks: int = 6) -> dict:
    """14c: overflow heal on the card: a time window over an undersized
    ring with strict_overflow.  The first three chunks are sparse in time
    (32 time units an event), the rest dense (1), so the ring of 8 first
    overflows after a checkpoint: the service quarantines, restores it
    onto a regrown ring and replays.  Its alerts and durable record ≡ a
    service over an engine sized large from the start."""
    from repro_torch.runtime import cumulative_matches
    from repro_torch.vector import PartitionedStreamingEngine, VectorEngine
    t_start = time.perf_counter()
    kidx, types, _ = part_draws(seed + 70, SMALL_L, SMALL_T, n_chunks)
    times = np.cumsum(np.where(np.arange(kidx.size) < 3 * SMALL_T, 32, 1))
    raws = raw_events(kidx, types, times=times)
    res = {}
    for name, mwe in (("small", 8), ("large", 64)):
        counters = reset_launches()
        eng = PartitionedStreamingEngine(
            VectorEngine(HEAL_QUERY, max_window_events=mwe), ("uid",),
            SMALL_T, SMALL_L, lane_cap=SMALL_CAP, strict_overflow=True)
        svc, _, alerts, _, t_end, _ = run_service(
            eng, work / f"heal_{name}", raws, checkpoint_every=2,
            max_window_events_cap=1024)
        res[name] = {"alerts": alerts, "metrics": svc.metrics,
                     "ring": eng.window.ring,
                     "cum": cumulative_matches(str(work / f"heal_{name}")),
                     "launches": read_launches(counters), "s": t_end}
    small, large = res["small"], res["large"]
    check(small["metrics"].overflows >= 1 and small["metrics"].regrows >= 1
          and small["metrics"].replayed_chunks >= 1 and
          large["metrics"].overflows == 0, "phase 14c: the small ring "
          "overflows, regrows and replays, the large one never overflows")
    check(small["cum"]["hits"] and small["alerts"] == large["alerts"] and
          small["cum"] == large["cum"], "phase 14c: the healed service's "
          "alerts and durable record ≡ the large-from-the-start service")
    check(max(small["cum"]["counts"].values()) < EXACT_LIMIT,
          "phase 14c: counts stay below 2^24")
    for name, r in res.items():
        check(r["launches"]["fused_scan"] >= n_chunks and
              r["launches"]["lane_route"] == r["launches"]["fused_scan"],
              f"phase 14c {name}: every step through the router and the "
              f"fused kernel, {r['launches']}")
    out = {"phase": 14, "case": "c: overflow heal on the card",
           "query": HEAL_QUERY, "lanes": SMALL_L, "T": SMALL_T,
           "chunks": n_chunks,
           "small": {"overflows": small["metrics"].overflows,
                     "regrows": small["metrics"].regrows,
                     "replayed_chunks": small["metrics"].replayed_chunks,
                     "ring": small["ring"], "launches": small["launches"],
                     "seconds": small["s"]},
           "large": {"ring": large["ring"], "launches": large["launches"],
                     "seconds": large["s"]},
           "hits": len(small["cum"]["hits"]),
           "max_count": max(small["cum"]["counts"].values()),
           "seconds": time.perf_counter() - t_start}
    emit(out)
    return out


def phase_single(seed: int, work: Path, T: int = 4096,
                 n_chunks: int = 8) -> dict:
    """14d: the single-stream adapter: a StreamingVectorEngine(batch=1)
    behind the service ≡ its direct feed_attrs."""
    from repro_torch.core.events import Event
    from repro_torch.runtime import cumulative_matches
    from repro_torch.vector import StreamingVectorEngine, VectorEngine
    t_start = time.perf_counter()
    query = MAIN_QUERY.format(100)
    rng = np.random.default_rng(seed + 80)
    types = rng.integers(0, len(PART_TYPES), (n_chunks, T))
    raws = [{"type": PART_TYPES[t]} for t in types.reshape(-1).tolist()]
    counters = reset_launches()
    se = StreamingVectorEngine(VectorEngine(query), T, 1)
    _, _, alerts, _, _, _ = run_service(se, work / "single", raws)
    launches = read_launches(counters)
    want = {k: 0 for k in launches}
    want.update(fused_scan=n_chunks)
    check(launches == want, f"phase 14d launched {launches}")
    direct = StreamingVectorEngine(VectorEngine(query), T, 1)
    hits = []
    counts = []
    for i in range(n_chunks):
        attrs = direct.encoder.encode_streams(
            [[Event(PART_TYPES[t], {}) for t in types[i].tolist()]])
        c, h = direct.feed_attrs(torch.from_numpy(attrs).to(direct.device))
        counts.append(c[:, 0])
        hits += h
    cum = cumulative_matches(str(work / "single"))
    got = log_counts(cum, T)
    want_counts = np.concatenate(counts)
    check(hits and same(got, want_counts[:len(got)]) and
          not want_counts[len(got):].any() and
          sorted(h for _, hs in alerts for h in hs) == sorted(hits),
          "phase 14d: the service's record and alerts ≡ direct feed_attrs")
    out = {"phase": 14, "case": "d: single-stream adapter", "query": query,
           "T": T, "chunks": n_chunks, "launches": launches,
           "hits": len(hits), "seconds": time.perf_counter() - t_start}
    emit(out)
    return out


def phase_runtime(seed: int) -> tuple:
    """Phase 14: 14a-d in a scratch directory of the checkout's build/
    tree (removed afterwards)."""
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "build"))
    try:
        svc = phase_service(seed, work)
        kill = phase_kill9(seed, work)
        phase_heal(seed, work)
        phase_single(seed, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return svc, kill


# ---------------------------------------------------------------------------
# phase 15: the QueryFleet on the card
# ---------------------------------------------------------------------------

# 15a: bucket A holds the phase-9 queries WITHIN 3200 events, bucket B two
# queries WITHIN 1600; churn applied before feeding chunk c:
# (op, qid, sequence, window)
FLEET_CHURN = {
    0: [("add", "a0", PACKED_SEQS[0], 3200), ("add", "a1", PACKED_SEQS[1],
                                              3200),
        ("add", "a2", PACKED_SEQS[2], 3200),
        ("add", "b0", "A1 ; A2 ; A3", 1600)],
    2: [("add", "a3", PACKED_SEQS[3], 3200)],
    3: [("add", "b1", "B1 ; B2 ; B3", 1600)],
    4: [("add", "a4", "A2 ; B1 ; A3", 3200)],     # Ŝ 28 → 35: the wide build
    5: [("remove", "a4", None, None)],
    6: [("remove", "a1", None, None),
        ("add", "a1b", PACKED_SEQS[1], 3200)],    # re-added: a cache hit
}
# 15a's kernel checks: the bucket (by window) just repacked before chunk c
FLEET_CHECKS = {2: 3200, 3: 1600, 4: 3200}
# 15d: 14 live predicates over five attributes, padded to 16 bits
BITS16_QUERIES = (
    "SELECT * FROM S WHERE (E AS a; E AS b; E AS c; E AS d) FILTER "
    "a[x > 1] AND a[y < 8] AND b[x > 3] AND b[z < 6] AND c[u > 2] AND "
    "c[v < 7] AND d[x < 5] AND d[y > 4] WITHIN 64 events",
    "SELECT * FROM S WHERE (E AS a; E AS b) FILTER a[z > 6] AND a[u < 3] "
    "AND b[v > 5] AND b[y > 2] AND a[x = 4] WITHIN 64 events")
# 15c: the fleet worker's churn, keyed to the chunk index (applied before
# feeding it), as tests/test_fleet.py's kill -9 worker
FLEET_KILL_CHUNKS, FLEET_KILL_AFTER, FLEET_KILL_EVERY = 12, 8, 3


def seq3_counts_all(codes: np.ndarray, eps: int) -> np.ndarray:
    """:func:`seq3_counts` for every lane at once: at each A3 position j,
    Σ over A2 positions i2 in [lo, j) of the A1s in [lo, i2), lo = max(0,
    j - eps), from prefix sums."""
    T, B = codes.shape
    zero = np.zeros((1, B), np.int64)
    a1 = np.vstack([zero, np.cumsum(codes == 0, axis=0)])
    a2 = codes == 1
    q = np.vstack([zero, np.cumsum(np.where(a2, a1[:-1], 0), axis=0)])
    n2 = np.vstack([zero, np.cumsum(a2, axis=0)])
    j = np.arange(T)
    lo = np.maximum(0, j - eps)
    out = (q[j] - q[lo]) - (n2[j] - n2[lo]) * a1[lo]
    return np.where(codes == 2, out, 0)


def type_events(types_tb: np.ndarray) -> list:
    """B streams of ``Event``s of a (T, B) type-index array."""
    from repro_torch.core.events import Event
    return [[Event(PART_TYPES[t], {}) for t in col]
            for col in types_tb.T.tolist()]


def bucket_engine(fleet, eps):
    """The engine of the fleet's ``WITHIN eps events`` bucket, or None."""
    b = fleet._buckets.get(("events", float(eps), None))
    return None if b is None else b.engine


def state_bytes(state) -> int:
    if isinstance(state, dict):
        return sum(state_bytes(v) for v in state.values())
    return state.numel() * state.element_size()


def fleet_kernel_check(eng, state, attrs, start, what) -> dict:
    """One chunk of a bucket's device step from a saved state: the fused
    kernel ≡ its plain version (counts and ring), each timed on the card,
    and the bound from the chunk's classes."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_scan import KERNEL
    from repro_torch.runtime.fleet import _pad_attrs
    o = eng._operands
    attrs = _pad_attrs(attrs, eng.geometry[4])

    def run(st, impl, trace=False):
        return ops.cer_pipeline(
            attrs, o["specs"], o["class_of"], o["class_ind"], o["m_all"],
            o["finals_q"], st, init_mask=o["init_mask"], window=eng.window,
            start_pos=start, impl=impl, latest_q=o["latest_q"],
            consume_sq=o["consume_sq"], inplace=True, return_trace=trace)
    got = run(clone_state(state), "fused", trace=True)
    plan = KERNEL.last_plan
    want = run(clone_state(state), "ref")
    check(same(got[0], want[0]) and same(got[1], want[1]),
          f"{what}: fused_scan ≡ plain on one chunk (counts and ring)")
    err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    trace = got[2]
    del got, want
    st = clone_state(state)
    ms = cuda_ms(lambda: run(st, "fused"), reps=3)
    plain_ms = cuda_ms(lambda: run(st, "ref"), reps=1)
    del st
    B, W = attrs.shape[1], eng.window.ring
    S, NQ = o["m_all"].shape[1], o["finals_q"].shape[0]
    bound = scan_bound(o["m_all"], o["finals_q"], trace, B, W, S, NQ)
    return {"S": S, "NQ": NQ, "k": len(o["specs"]), "W": W,
            "state_bucket": eng._entry.state_bucket, "n_split": plan[1],
            "use_smem": plan[0], "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "max_abs_err": err}


def phase_fleet(seed: int, B: int = 1024, n_chunks: int = 8) -> dict:
    """15a: QueryFleet(chunk_len=256, batch=1024) on the card, phase 9's
    draws as Events, the churn of ``FLEET_CHURN``; every live query ≡ its
    closed form over its suffix on every lane."""
    from repro_torch.kernels.build import LIBRARY
    from repro_torch.runtime import QueryFleet
    from repro_torch.runtime.fleet import _FleetStreamEngine
    from repro_torch.vector.encoder import EventEncoder
    T = 256
    t_start = time.perf_counter()
    rng = np.random.default_rng(seed + 9)        # phase 9's draws
    draws = rng.integers(0, len(PART_TYPES), (n_chunks * T, B))
    fleet = QueryFleet(chunk_len=T, batch=B)
    acc = {"encode": 0.0, "step": 0.0}
    enc_orig = EventEncoder.encode_streams
    step_orig = _FleetStreamEngine._device_step

    def enc_timed(self, streams):
        t0 = time.perf_counter()
        out = enc_orig(self, streams)
        acc["encode"] += time.perf_counter() - t0
        return out

    def step_timed(self, attrs, event_ts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_orig(self, attrs, event_ts)
        torch.cuda.synchronize()
        acc["step"] += time.perf_counter() - t0
        return out
    texts, lives, repacks, chunks, saved = {}, {}, [], [], {}
    torch.cuda.reset_peak_memory_stats()
    counters = reset_launches()
    EventEncoder.encode_streams = enc_timed
    _FleetStreamEngine._device_step = step_timed
    try:
        for c in range(n_chunks):
            for op, qid, seq, eps in FLEET_CHURN.get(c, ()):
                if op == "add":
                    texts[qid] = (seq, eps)
                seq, eps = texts[qid]
                old = bucket_engine(fleet, eps)
                hits0 = fleet.cache_hits
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if op == "add":
                    fleet.add_query(PACKED_QUERY.format(seq, eps), qid=qid)
                    lives[qid] = (c, [])
                else:
                    fleet.remove_query(qid)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                new = bucket_engine(fleet, eps)
                repacks.append({
                    "chunk": c, "op": op, "qid": qid, "ms": ms,
                    "S_padded": new.geometry[0] if new else None,
                    "bytes_to_host": state_bytes(old.state) if old else 0,
                    "bytes_to_device": state_bytes(new.state) if new else 0,
                    "cache_hit": fleet.cache_hits > hits0})
            if c == 6:
                check(repacks[-1]["cache_hit"], "phase 15a: the re-add "
                      "under a fresh qid is a cache hit")
            if c in FLEET_CHECKS:        # a bucket just repacked, kept for
                eng = bucket_engine(fleet, FLEET_CHECKS[c])   # its check
                saved[f"{FLEET_CHECKS[c]}@{c}"] = (
                    eng, clone_state(eng.state), c)
            streams = type_events(draws[c * T:(c + 1) * T])
            acc.update(encode=0.0, step=0.0)
            n0 = counters["fused_scan"].launches
            t0 = time.perf_counter()
            counts, hits = fleet.feed(streams)
            feed_s = time.perf_counter() - t0
            del streams
            check(counters["fused_scan"].launches - n0 == fleet.num_buckets,
                  f"phase 15a chunk {c}: one fused_scan launch per bucket")
            for qid in fleet.live_qids:
                lives[qid][1].append(
                    counts[:, :, fleet.live_qids.index(qid)])
            chunks.append({"chunk": c, "buckets": fleet.num_buckets,
                           "queries": fleet.num_queries, "hits": len(hits),
                           "feed_ms": 1e3 * feed_s,
                           "encode_ms": 1e3 * acc["encode"],
                           "device_step_ms": 1e3 * acc["step"],
                           "copy_and_depack_ms": 1e3 * (
                               feed_s - acc["encode"] - acc["step"])})
            del counts, hits
    finally:
        EventEncoder.encode_streams = enc_orig
        _FleetStreamEngine._device_step = step_orig
    launches = read_launches(counters)
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {k: 0 for k in launches}
    want["fused_scan"] = sum(ch["buckets"] for ch in chunks)
    check(launches == want, f"phase 15a launched {launches}")
    check(LIBRARY.loads == 1, f"phase 15a: one library load, got "
          f"{LIBRARY.loads}")
    check(fleet.compile_count <= fleet.distinct_geometries,
          "phase 15a: compile_count ≤ distinct_geometries")
    # every lifetime ≡ its closed form over the suffix after its add
    n_counts = 0
    for qid, (c0, got) in lives.items():
        seq, eps = texts[qid]
        own = packed_codes(draws[c0 * T:(c0 + len(got)) * T], PART_TYPES,
                           seq.split(" ; "))
        got = np.concatenate(got)
        check(got.max() < EXACT_LIMIT, "phase 15a: counts below 2^24")
        check(same(got, seq3_counts_all(own, eps)),
              f"phase 15a: {qid} ({seq}) ≡ its closed form over chunks "
              f"{c0}-{c0 + len(got) // T - 1} on all {B} lanes")
        n_counts += int(got.sum())
    del lives
    kernels = {}
    for key, (eng, state, c) in saved.items():
        vocab = eng.encoder.vocab["type"]
        check(eng.encoder.attrs == ("type",), "phase 15a: type-only "
              "encoders")
        lut = torch.tensor([vocab.get(t, -1.0) for t in PART_TYPES],
                           device=eng.device)
        attrs = lut[torch.from_numpy(draws[c * T:(c + 1) * T]).to(
            eng.device)][:, :, None]
        kernels[key] = fleet_kernel_check(eng, state, attrs, c * T,
                                          f"phase 15a bucket {key}")
        del state, attrs
    del saved
    out = {"phase": 15, "case": "a: QueryFleet at full width", "B": B,
           "T": T, "chunks": n_chunks, "launches": launches,
           "library_loads": LIBRARY.loads,
           "compile_count": fleet.compile_count,
           "distinct_geometries": fleet.distinct_geometries,
           "cache_hits": fleet.cache_hits, "matches": n_counts,
           "per_chunk": chunks, "repacks": repacks, "kernels": kernels,
           "feed_ms_median": float(np.median([ch["feed_ms"]
                                              for ch in chunks])),
           "device_share": sum(ch["device_step_ms"] for ch in chunks)
           / sum(ch["feed_ms"] for ch in chunks),
           "peak_mem_GB": peak, "seconds": time.perf_counter() - t_start}
    emit(out)
    return out


def arena_state_err(a, b, cap: int) -> float:
    """Largest difference of two arena engines' count state and arena
    (node store below the sink slot, cells, pointers)."""
    ka, pa = a.state["arena"], b.state["arena"]
    err = max_abs_err(a.state["C"], b.state["C"])
    for name in ("kind", "pos", "maxs", "left", "right"):
        err = max(err, max_abs_err(ka[name][:, :cap], pa[name][:, :cap]))
    return max(err, max_abs_err(ka["cell"], pa["cell"]),
               max_abs_err(ka["ptr"], pa["ptr"]))


def phase_fleet_arena(seed: int, B: int = 64, n_chunks: int = 4) -> dict:
    """15b: the fleet with the arena at phase 5's width (64 lanes, ring
    3208, ``arena_capacity=2**18``): q1 (phase 5's query) and q2 from chunk
    0, q2 removed before chunk 2 (a repack with the arena live) and re-added
    under a fresh qid before chunk 3 (a cache hit that reuses the arena
    tables).  The kernel fleet ≡ a plain fleet (``impl="ref"``) on every
    chunk: counts, hits, count state, node store, cells, pointers, roots
    and cost reports; lane 0 of q1 ≡ the host Engine."""
    from repro_torch.runtime import QueryFleet
    T, eps, cap = 256, 3200, 1 << 18
    t_start = time.perf_counter()
    q1, q2 = MAIN_QUERY.format(eps), PACKED_QUERY.format("B1 ; B2 ; B3",
                                                          eps)
    churn = {0: [("add", "q1", q1), ("add", "q2", q2)],
             2: [("remove", "q2", None)], 3: [("add", "q2b", q2)]}
    rng = np.random.default_rng(seed + 150)
    draws = rng.integers(0, len(PART_TYPES), (n_chunks * T, B))
    draws[:, 0] = rng.choice(len(PART_TYPES), n_chunks * T,
                             p=[0.01] * 3 + [0.97 / 6] * 6)
    fleets = {impl: QueryFleet(chunk_len=T, batch=B, arena_capacity=cap,
                               impl=impl) for impl in ("fused", "ref")}
    kern = fleets["fused"]
    counters = reset_launches()
    feed_ms, repack_ms, err, lane0, tables = [], [], 0.0, {}, None
    for c in range(n_chunks):
        for op, qid, text in churn.get(c, ()):
            for impl, f in fleets.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if op == "add":
                    f.add_query(text, qid=qid)
                else:
                    f.remove_query(qid)
                torch.cuda.synchronize()
                if impl == "fused":
                    repack_ms.append(1e3 * (time.perf_counter() - t0))
        if c == 0:
            tables = kern._find_bucket("q1").engine._arena_tables
        if c == 3:
            check(kern._find_bucket("q2b").engine._arena_tables is tables,
                  "phase 15b: the re-added query's bucket reuses the "
                  "cached arena tables")
        streams = type_events(draws[c * T:(c + 1) * T])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck, hk = kern.feed(streams)
        feed_ms.append(1e3 * (time.perf_counter() - t0))
        cp, hp = fleets["ref"].feed(streams)
        check(same(ck, cp) and hk == hp, f"phase 15b chunk {c}: counts and "
              "hits ≡ the plain fleet")
        ek = kern._find_bucket("q1").engine
        ep = fleets["ref"]._find_bucket("q1").engine
        check_engines_equal(ek, ep, f"phase 15b chunk {c}")
        check(not bool(ek.state["arena"]["ovf"].any()),
              "phase 15b: arena ovf stays clear")
        err = max(err, arena_state_err(ek, ep, cap))
        check(kern.cost_report() == fleets["ref"].cost_report(),
              f"phase 15b chunk {c}: cost reports (arena cells and nodes) "
              "≡ the plain fleet's")
        col = kern.live_qids.index("q1")
        for t in np.nonzero(ck[:, 0, col])[0].tolist():
            lane0[c * T + t] = ceset(kern.enumerate("q1", c * T + t, 0))
    launches = read_launches(counters)
    want = {k: 0 for k in launches}
    want.update(fused_scan=n_chunks, arena_update=n_chunks)
    check(launches == want, f"phase 15b launched {launches}")
    stream0 = type_events(draws[:, :1])[0]
    want_sets = host_sets(q1, stream0)
    check(lane0 == want_sets, f"phase 15b: lane 0 of q1 enumerates what the "
          f"host Engine finds ({sum(map(len, lane0.values()))} vs "
          f"{sum(map(len, want_sets.values()))} complex events)")
    rep = kern.cost_report()
    out = {"phase": 15, "case": "b: the fleet with the arena", "B": B,
           "T": T, "chunks": n_chunks, "arena_capacity": cap,
           "launches": launches, "feed_ms": feed_ms,
           "repack_ms": repack_ms, "max_abs_err": err,
           "lane0_complex_events": sum(map(len, lane0.values())),
           "arena_cells": {q: r["arena_cells"] for q, r in rep.items()},
           "arena_nodes": {q: r["arena_nodes"] for q, r in rep.items()},
           "cache_hits": kern.cache_hits,
           "compile_count": kern.compile_count,
           "seconds": time.perf_counter() - t_start}
    emit(out)
    return out


def phase_fleet_bits16(seed: int, B: int = 256, n_chunks: int = 3) -> dict:
    """15d: a bucket of 14 live predicates over five attributes (``NaN``
    where an event lacks one), padded to 16 bits and eight attribute
    columns, through the fused kernel ≡ a plain fleet; the kernel alone ≡
    plain on one more chunk, with its time and bound."""
    from repro_torch.core.events import Event
    from repro_torch.runtime import QueryFleet
    T = 256
    t_start = time.perf_counter()
    rng = np.random.default_rng(seed + 160)
    names = ("x", "y", "z", "u", "v")

    def chunk():
        vals = rng.integers(0, 10, (B, T, len(names))).tolist()
        miss = (rng.random((B, T, len(names))) < 0.1).tolist()
        return [[Event("E", {a: float(v) for a, v, m in
                             zip(names, vs, ms) if not m})
                 for vs, ms in zip(vrow, mrow)]
                for vrow, mrow in zip(vals, miss)]
    fleets = {impl: QueryFleet(chunk_len=T, batch=B, impl=impl)
              for impl in ("fused", "ref")}
    counters = reset_launches()
    for c in range(n_chunks):
        if c < len(BITS16_QUERIES):
            for f in fleets.values():
                f.add_query(BITS16_QUERIES[c], qid=f"w{c}")
        streams = chunk()
        ck, hk = fleets["fused"].feed(streams)
        cp, hp = fleets["ref"].feed(streams)
        check(same(ck, cp) and hk == hp, f"phase 15d chunk {c}: counts and "
              "hits ≡ the plain fleet")
        check(ck.max() < EXACT_LIMIT, "phase 15d: counts below 2^24")
        check(same(fleets["fused"]._find_bucket("w0").engine.state,
                   fleets["ref"]._find_bucket("w0").engine.state),
              f"phase 15d chunk {c}: ring ≡ the plain fleet's")
    launches = read_launches(counters)
    want = {k: 0 for k in launches}
    want["fused_scan"] = n_chunks
    check(launches == want, f"phase 15d launched {launches}")
    eng = fleets["fused"]._find_bucket("w0").engine
    pk = eng.engine.packing
    check((pk.num_bits, pk.padded_bits, eng.geometry[4]) == (14, 16, 8),
          "phase 15d: 14 live bits padded to 16, six attributes to eight")
    check(int(ck.sum()) > 0, "phase 15d: the queries match")
    streams = chunk()
    attrs = torch.from_numpy(eng.encoder.encode_streams(streams)).to(
        eng.device)
    kern = fleet_kernel_check(eng, clone_state(eng.state), attrs,
                              n_chunks * T, "phase 15d")
    out = {"phase": 15, "case": "d: 16 padded predicate bits", "B": B,
           "T": T, "chunks": n_chunks, "launches": launches,
           "matches": int(ck.sum()), "kernel": kern,
           "seconds": time.perf_counter() - t_start}
    emit(out)
    return out


def cumulative_nd(per_chunk) -> dict:
    """The durable-record form (``MatchLog.cumulative``) of direct feeds:
    ``counts`` ``{(chunk, *index): v}`` over nonzero cells, sorted hits."""
    counts, hits = {}, set()
    for c, (cnt, h) in enumerate(per_chunk):
        nz = np.nonzero(cnt)
        for idx, v in zip(zip(*(x.tolist() for x in nz)),
                          cnt[nz].tolist()):
            counts[(c, *idx)] = int(v)
        hits.update(tuple(x) for x in h)
    return {"hits": sorted(hits), "counts": counts}


def fleet_service_queries():
    """15c's batch-1 fleet: bucket A (phase 9's queries) and bucket B."""
    return ([(f"a{i}", PACKED_QUERY.format(s, 3200))
             for i, s in enumerate(PACKED_SEQS)]
            + [("b0", PACKED_QUERY.format("A1 ; A2 ; A3", 1600))])


def fleet_kill_run(directory, crash_after: int, seed: int) -> dict:
    """15c's crash worker: a RecoveringStreamRunner over a 64-lane fleet on
    the card, churn keyed to the chunk index (q b joins at 2, q c in a new
    bucket at 5, q b leaves at 8), checkpoints every 3 chunks; SIGKILLs
    itself once ``crash_after`` chunks are fed (-1: never)."""
    from repro_torch.runtime import QueryFleet, RecoveringStreamRunner
    T, L = 256, 64
    rng = np.random.default_rng(seed + 170)
    draws = rng.integers(0, len(PART_TYPES), (FLEET_KILL_CHUNKS * T, L))
    fleet = QueryFleet(chunk_len=T, batch=L)
    fleet.add_query(PACKED_QUERY.format(PACKED_SEQS[0], 3200), qid="qa")
    churn = {2: ("add", "qb", PACKED_QUERY.format(PACKED_SEQS[1], 3200)),
             5: ("add", "qc", PACKED_QUERY.format("A1 ; A2 ; A3", 1600)),
             8: ("remove", "qb", None)}
    runner = RecoveringStreamRunner(fleet, str(directory),
                                    every=FLEET_KILL_EVERY)
    resumed = runner.chunk_index if runner.resume() else None
    replayed = 0
    for i in range(runner.chunk_index, FLEET_KILL_CHUNKS):
        op, qid, text = churn.get(i, (None, None, None))
        if op == "add":
            fleet.add_query(text, qid=qid)
        elif op == "remove":
            fleet.remove_query(qid)
        _, _, emitted = runner.process(type_events(draws[i * T:(i + 1) * T]))
        replayed += not emitted
        if runner.chunk_index == crash_after:
            print(json.dumps({"killed_after": crash_after}), flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
    runner.close()
    return {"resumed_at": resumed, "replayed": replayed,
            "live_qids": fleet.live_qids}


def phase_fleet_service(seed: int, work: Path, T: int = 4096,
                        n_chunks: int = 8) -> dict:
    """15c: the StreamService over a batch-1 fleet on the card ≡ a direct
    ``fleet.feed`` of the same chunks; then a fleet runner SIGKILLed
    mid-churn in a subprocess and resumed ≡ an uninterrupted run."""
    from repro_torch.core.events import Event
    from repro_torch.runtime import QueryFleet, cumulative_matches
    t_start = time.perf_counter()

    def mk():
        fleet = QueryFleet(chunk_len=T, batch=1)
        for qid, text in fleet_service_queries():
            fleet.add_query(text, qid=qid)
        return fleet
    rng = np.random.default_rng(seed + 165)
    types = rng.integers(0, len(PART_TYPES), (n_chunks, T))
    raws = [{"type": PART_TYPES[t]} for t in types.reshape(-1).tolist()]
    counters = reset_launches()
    svc, receipts, alerts, t_sub, t_end, inst = run_service(
        mk(), work / "fleet_service", raws, checkpoint_every=4)
    launches = read_launches(counters)
    want = {k: 0 for k in launches}
    want["fused_scan"] = 2 * n_chunks
    check(launches == want, f"phase 15c launched {launches}, expected one "
          "fused_scan launch per bucket per chunk")
    check(all(r.accepted for r in receipts) and svc.metrics.chunks ==
          n_chunks, "phase 15c: every event accepted, every chunk stepped")
    direct = mk()
    per_chunk = [direct.feed([[Event(PART_TYPES[t], {})
                               for t in types[i].tolist()]])
                 for i in range(n_chunks)]
    cum = cumulative_matches(str(work / "fleet_service"))
    want_cum = cumulative_nd(per_chunk)
    check(cum["hits"] and cum == want_cum and sorted(
        tuple(h) for _, hs in alerts for h in hs) == want_cum["hits"],
          "phase 15c: the service's record and alerts ≡ a direct "
          "fleet.feed")
    out = {"phase": 15, "case": "c: the service over a fleet, kill -9",
           "service": {"T": T, "chunks": n_chunks,
                       "events_per_s": len(raws) / t_end,
                       "step_ms": ms_list(inst[0]["step"]),
                       "encode_ms": ms_list(inst[0]["encode"]),
                       "hits": len(cum["hits"])}}

    # kill -9 mid-churn: the runner in-process, then crash and restart
    counters = reset_launches()
    oracle = fleet_kill_run(work / "fleet_ref", -1, seed)
    launches = read_launches(counters)
    want = {k: 0 for k in launches}
    want["fused_scan"] = 5 + 2 * (FLEET_KILL_CHUNKS - 5)
    check(launches == want, f"phase 15c runner launched {launches}")
    d = work / "fleet_crash"
    rc, first, err = worker(["--fleet-worker", str(d), "--crash-after",
                             str(FLEET_KILL_AFTER), "--seed", str(seed)])
    check(rc == -signal.SIGKILL and first == {"killed_after":
                                              FLEET_KILL_AFTER},
          f"phase 15c: the fleet worker dies by SIGKILL, rc={rc}: {err}")
    rc, second, err = worker(["--fleet-worker", str(d), "--seed",
                              str(seed)])
    check(rc == 0 and second["resumed_at"] == 6 and second["replayed"] == 2
          and second["live_qids"] == oracle["live_qids"] == ["qa", "qc"],
          f"phase 15c: the restart resumes at chunk 6, replays 6-7 and "
          f"ends with qa and qc, rc={rc} {second}: {err}")
    want_cum = cumulative_matches(str(work / "fleet_ref"))
    check(want_cum["hits"] and cumulative_matches(str(d)) == want_cum,
          "phase 15c: the fleet's record after kill -9 mid-churn ≡ the "
          "uninterrupted run")
    out["kill9"] = {"launches": launches, "restart": second,
                    "hits": len(want_cum["hits"])}
    out["seconds"] = time.perf_counter() - t_start
    emit(out)
    return out


def phase_fleets(seed: int) -> tuple:
    """Phase 15: 15a-d (15c in a scratch directory of the checkout's
    build/ tree, removed afterwards)."""
    a = phase_fleet(seed)
    b = phase_fleet_arena(seed)
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "build"))
    try:
        c = phase_fleet_service(seed, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    d = phase_fleet_bits16(seed)
    return a, b, c, d


# phase 16: the sharded engine on an NCCL group of one rank
DIST_FAULT_QUERY = ("SELECT * FROM S WHERE A AS a ; B AS b "
                    "FILTER a[price > 5.0] WITHIN 8 events")


def dist_sharded_scans(g, seed: int, B: int = 1024, n_chunks: int = 8
                       ) -> dict:
    """16a: phase 1's draws through sharded_cer_pipeline on this rank's
    lanes ≡ the unsharded ops.cer_pipeline; phase 8's class ids through
    sharded_cea_scan ≡ ops.cea_scan."""
    from repro_torch.kernels import ops, ref
    from repro_torch.vector import VectorEngine
    from repro_torch.vector.distributed import (sharded_cea_scan,
                                                sharded_cer_pipeline)
    T, eps = 256, 3200
    types = ["A1", "A2", "A3"] + [f"B{i}" for i in range(1, 7)]
    ve = VectorEngine(MAIN_QUERY.format(eps))
    t = ve.tables
    check(t.latest_q is None and t.consume_sq is None, "phase 1's query "
          "has neither LAST nor CONSUME")
    rng = np.random.default_rng(seed)
    chunks = [type_attrs(ve.encoder, rng, T, B, types, ve.device)
              for _ in range(n_chunks)]
    tables = (ve.encoder.specs, t.class_of, t.class_ind, t.m_all,
              t.finals[None, :])
    ring_sh = g.block(ve.init_state(B), 0)
    ring_un = ve.init_state(B)

    def sharded(attrs, ring, i):
        return sharded_cer_pipeline(
            g, g.block(attrs, 1), *tables, ring, init_mask=t.init_mask,
            epsilon=eps, start_pos=torch.tensor(i * T, device=ve.device),
            inplace=True)

    def unsharded(attrs, ring, i):
        return ops.cer_pipeline(attrs, *tables, ring, init_mask=t.init_mask,
                                epsilon=eps, start_pos=i * T, impl="fused",
                                inplace=True)
    torch.cuda.synchronize()
    counters = reset_launches()
    m_sh = [sharded(a, ring_sh, i)[0] for i, a in enumerate(chunks)]
    launches = read_launches(counters)
    want = {k: 0 for k in launches}
    want.update(fused_scan=n_chunks)
    check(launches == want, f"16a: sharded_cer_pipeline launched "
          f"{launches}, expected one fused_scan launch per chunk")
    m_un = [unsharded(a, ring_un, i)[0] for i, a in enumerate(chunks)]
    check(all(same(x, y) for x, y in zip(m_sh, m_un)) and
          same(ring_sh, ring_un), "16a: sharded_cer_pipeline ≡ the "
          "unsharded ops.cer_pipeline (counts and ring)")
    err = max(max(max_abs_err(x, y) for x, y in zip(m_sh, m_un)),
              max_abs_err(ring_sh, ring_un))
    check(torch.cat(m_sh).max().item() < EXACT_LIMIT, "counts stay below "
          "2^24")
    matches = int(torch.cat(m_sh).sum().item())
    del m_sh, m_un
    # chunk time from the final ring, sharded and unsharded in turns
    st_a, st_b = ring_sh.clone(), ring_un.clone()
    turns = {"unsharded": [], "sharded": []}
    for _ in range(2):
        turns["unsharded"].append(cuda_ms(
            lambda: unsharded(chunks[0], st_b, n_chunks), reps=5))
        turns["sharded"].append(cuda_ms(
            lambda: sharded(chunks[0], st_a, n_chunks), reps=5))
    del st_a, st_b

    # phase 8's class ids through the single-query scan kernel
    flat = chunks[0].reshape(T * B, chunks[0].shape[2])
    ids = t.class_of[ref.bitvector(flat, ve.encoder.specs).long()].reshape(
        T, B)
    start = n_chunks * T
    counters = reset_launches()
    got = sharded_cea_scan(g, g.block(ids, 1), t.m_all, t.finals,
                           g.block(ring_sh, 0).clone(), epsilon=eps,
                           start_pos=torch.tensor(start, device=ve.device))
    scan_launches = read_launches(counters)
    want = {k: 0 for k in scan_launches}
    want.update(cea_scan=1)
    check(scan_launches == want, f"16a: sharded_cea_scan launched "
          f"{scan_launches}, expected one cea_scan launch")
    plain = ops.cea_scan(ids, t.m_all, t.finals, ring_sh.clone(),
                         epsilon=eps, start_pos=start)
    check(same(got[0], plain[0]) and same(got[1], plain[1]),
          "16a: sharded_cea_scan ≡ ops.cea_scan (counts and ring)")
    err = max(err, max_abs_err(got[0], plain[0]),
              max_abs_err(got[1], plain[1]))
    del got, plain
    st_a, st_b = ring_sh.clone(), ring_sh.clone()
    scan_ms = cuda_ms(lambda: sharded_cea_scan(
        g, ids, t.m_all, t.finals, st_a, epsilon=eps, start_pos=start),
        reps=5)
    scan_un_ms = cuda_ms(lambda: ops.cea_scan(
        ids, t.m_all, t.finals, st_b, epsilon=eps, start_pos=start,
        inplace=True), reps=5)
    return {"case": "16a sharded scans", "B": B, "T": T,
            "chunks": n_chunks, "W": ve.ring, "launches": launches,
            "cea_scan_launches": scan_launches, "matches": matches,
            "sharded_pipeline_ms": turns["sharded"],
            "unsharded_pipeline_ms": turns["unsharded"],
            "sharded_cea_scan_ms": scan_ms,
            "unsharded_cea_scan_ms": scan_un_ms, "max_abs_err": err}


def dist_routed_feed(g, seed: int, L: int = 1024, T: int = 262144,
                     cap: int = 384, n_chunks: int = 8):
    """16b: phase 13's draws through route_partitioned_chunk and
    feed_keyed(positions=) ≡ phase 13's unsharded feed, fed in turns."""
    from repro_torch.kernels import ref
    from repro_torch.vector.distributed import (bucket_rows, exchange_rows,
                                                pack_rows,
                                                route_partitioned_chunk)
    eps = 3200
    query = MAIN_QUERY.format(eps)
    kidx, types, keys = part_draws(seed + 30, L, T, n_chunks)
    routed_eng = part_engine(query, T, L, cap)
    plain_eng = part_engine(query, T, L, cap)
    dev = routed_eng.device
    codes = torch.tensor([routed_eng.encoder.vocab["type"].get(x, -1.0)
                          for x in PART_TYPES], device=dev)
    chunks = [codes[torch.from_numpy(types[i]).to(dev)][:, None].contiguous()
              for i in range(n_chunks)]
    keys_dev = [ref.key_bits(torch.from_numpy(k)).to(dev).view(torch.uint32)
                for k in keys]
    got = np.zeros(n_chunks * T, np.int64)
    want, hits_r, hits_u = [], [], []
    launches, route_s, feed_s, plain_s = None, [], [], []
    for i in range(n_chunks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, h = plain_eng.feed_keyed(chunks[i], keys[i])
        plain_s.append(time.perf_counter() - t0)
        want.append(c)
        hits_u += h
        counters = reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pos = torch.arange(i * T, (i + 1) * T, dtype=torch.int32,
                           device=dev)
        a2, k2, p2, valid, keep = route_partitioned_chunk(
            g, g.block(chunks[i]), g.block(keys_dev[i]), g.block(pos))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        p2_np = p2.cpu().numpy()
        c, h = routed_eng.feed_keyed(a2, k2, positions=p2_np)
        feed_s.append(time.perf_counter() - t1)
        route_s.append(t1 - t0)
        v = valid.cpu().numpy()
        got[p2_np[v]] = c[v]
        hits_r += h
        step = read_launches(counters)
        launches = step if launches is None else {
            k: launches[k] + step[k] for k in step}
        check(bool(keep.cpu().numpy().sum() == v.sum()) and
              int(v.sum()) == int((kidx[i] >= 0).sum()), "16b: every "
              "keyed event arrives (no spill on one rank)")
    want_l = {k: 0 for k in launches}
    want_l.update(lane_route=n_chunks, fused_scan=n_chunks)
    check(launches == want_l, f"16b: the routed feed launched {launches}, "
          "expected one lane_route and one fused_scan launch per chunk")
    check(same(got, np.concatenate(want)) and sorted(hits_r) == hits_u,
          "16b: routed feed ≡ phase 13's unsharded feed (counts and hits)")
    check(same(routed_eng.state, plain_eng.state), "16b: routed engine's "
          "state ≡ the unsharded engine's")
    # the router alone on chunk 0: bucket sort, then the all_to_all
    a, k, pos = chunks[0], keys_dev[0], torch.arange(T, dtype=torch.int32,
                                                     device=dev)
    bits = ref.key_bits(k)
    null = bits == -1
    dest = ((bits.to(torch.int64) & 0xFFFFFFFF) % g.world_size).to(
        torch.int32)
    cols = torch.cat([a.view(torch.int32), torch.stack(
        [bits, pos, torch.ones_like(bits)], 1)], 1)

    def bucket():
        slot, _ = bucket_rows(dest, null, g.world_size)
        return pack_rows(cols, slot, g.world_size)
    send = bucket()
    bucket_ms = cuda_ms(bucket, reps=20)
    a2a_ms = cuda_ms(lambda: exchange_rows(g, send), reps=20)
    route_ms = cuda_ms(lambda: route_partitioned_chunk(g, a, k, pos),
                       reps=20)
    route_med = float(np.median(route_s))
    feed_med, plain_med = float(np.median(feed_s)), float(np.median(plain_s))
    res = {"case": "16b routed feed", "lanes": L, "T": T, "lane_cap": cap,
           "chunks": n_chunks, "launches": launches,
           "matches": int(got.sum()), "hits": len(hits_r),
           "router_ms_per_chunk": route_ms,
           "router_bucket_sort_ms": bucket_ms,
           "router_all_to_all_ms": a2a_ms,
           "all_to_all_bytes": send.numel() * 4,
           "router_host_ms_median": 1e3 * route_med,
           "routed_feed_ms_median": 1e3 * feed_med,
           "routed_feed_ms": [1e3 * x for x in feed_s],
           "routed_events_per_s": T / (route_med + feed_med),
           "unsharded_feed_ms_median": 1e3 * plain_med,
           "unsharded_feed_ms": [1e3 * x for x in plain_s],
           "unsharded_events_per_s": T / plain_med}
    del plain_eng
    return res, routed_eng


def dist_fault_case(g) -> dict:
    """16c: NULL-keyed events without the filtered attribute (NaN rows
    dropped by the router): route and feed on the card ≡ the host
    PartitionedEngine."""
    import random

    from repro_torch.core import compile_query
    from repro_torch.core.engine import Engine, WindowSpec
    from repro_torch.core.events import Event
    from repro_torch.core.partition import NULL_KEY_HASH, PartitionedEngine
    from repro_torch.vector import PartitionedStreamingEngine, VectorEngine
    from repro_torch.vector.distributed import route_partitioned_chunk
    rng = random.Random(6)
    stream = []
    for _ in range(64):
        attrs = {} if rng.random() < 0.25 else \
            {"uid": rng.choice(["u1", "u2", "u3"]),
             "price": float(rng.randint(0, 10))}
        stream.append(Event(rng.choice("AB"), attrs))
    q = compile_query(DIST_FAULT_QUERY)
    host = PartitionedEngine(
        lambda: Engine(q.cea, window=WindowSpec.events(8)), ("uid",))
    want = [len(host.process(e)) for e in stream]
    ve = VectorEngine(DIST_FAULT_QUERY)
    eng = PartitionedStreamingEngine(ve, ("uid",), chunk_len=16,
                                     num_lanes=8)
    got = np.zeros(len(stream), np.int64)
    nan_dropped = 0
    for lo in range(0, len(stream), 16):
        attrs, keys = ve.encoder.encode_stream_with_keys(
            stream[lo:lo + 16], ("uid",))
        nan_dropped += int(np.isnan(
            attrs[keys == np.uint32(NULL_KEY_HASH)]).any(axis=1).sum())
        pos = torch.arange(lo, lo + 16, dtype=torch.int32, device=ve.device)
        a2, k2, p2, valid, _ = route_partitioned_chunk(
            g, torch.from_numpy(attrs).to(ve.device), keys, pos)
        p2 = p2.cpu().numpy()
        c, _ = eng.feed_keyed(a2, k2, positions=p2)
        v = valid.cpu().numpy()
        got[p2[v]] = c[v]
    check(nan_dropped > 0, "16c: dropped rows carry NaN")
    check(got.tolist() == want and sum(want) > 0, f"16c: route and feed on "
          f"the card ({int(got.sum())} matches) ≡ the host "
          f"PartitionedEngine ({sum(want)})")
    return {"case": "16c NaN rows dropped by the router", "events": 64,
            "matches": int(got.sum()), "nan_rows_dropped": nan_dropped}


def dist_restore(g, eng, work: Path) -> dict:
    """16d: a checkpoint of 16b's engine state, restored onto the card by
    restore_resharded (lane-indexed leaves as this rank's block) ≡ the
    live state, leaf for leaf."""
    from repro_torch.checkpoint import (CheckpointManager, LaneShard,
                                        restore_resharded)
    state = eng.state
    mgr = CheckpointManager(str(work / "ckpt"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(1, state, extra={"position": eng.position})
    t1 = time.perf_counter()
    shard = LaneShard(g, 0)
    placed, extra = restore_resharded(mgr, state,
                                      {k: shard for k in state})
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for k in state:
        check(placed[k].device == g.device and
              same(placed[k], g.block(state[k], 0)),
              f"16d: restored leaf {k} ≡ the live state's block")
    check(extra == {"position": eng.position}, "16d: extra restored")
    nbytes = sum(v.numel() * v.element_size() for v in state.values())
    return {"case": "16d restore_resharded", "leaves": sorted(state),
            "bytes": nbytes, "save_ms": 1e3 * (t1 - t0),
            "restore_ms": 1e3 * (t2 - t1)}


def dist_examples() -> dict:
    """16e: both examples on the card and with --device cpu, and the dry
    run on the card, as subprocesses at once; each example prints the
    same lines on both."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = {}
    for name in ("torch_quickstart", "torch_multi_query"):
        for dev in ("cuda", "cpu"):
            args = [] if dev == "cuda" else ["--device", "cpu"]
            runs[(name, dev)] = [sys.executable,
                                 str(ROOT / "examples" / f"{name}.py")] + args
    runs[("cer_dryrun", "cuda")] = [sys.executable, "-m",
                                    "repro_torch.launch.cer_dryrun"]
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(cmd, env=env, cwd=ROOT, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, cmd in runs.items()}
    out, secs = {}, {}
    try:
        for k, p in procs.items():
            o, e = p.communicate(timeout=300)
            secs["/".join(k)] = time.perf_counter() - t0
            check(p.returncode == 0, f"16e: {' '.join(k)} exited "
                  f"{p.returncode}: {e[-2000:]}")
            out[k] = o
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name in ("torch_quickstart", "torch_multi_query"):
        check(out[(name, "cuda")] == out[(name, "cpu")] and
              out[(name, "cuda")].strip(), f"16e: {name} prints the same "
              f"lines on the card and the CPU")
    dry = out[("cer_dryrun", "cuda")].splitlines()
    check(len(dry) == 2 and all("cuda:0" in ln or "all_to_all" in ln
                                for ln in dry), f"16e: dry run: {dry}")
    return {"case": "16e examples and dry run",
            "quickstart": out[("torch_quickstart", "cuda")].splitlines(),
            "multi_query": out[("torch_multi_query", "cuda")].splitlines(),
            "dryrun": dry, "seconds": secs}


def phase_distributed(seed: int, part_res: dict, smi: str) -> dict:
    """Phase 16: the sharded engine on an NCCL group of world size 1
    (file store in a scratch directory of build/, removed afterwards)."""
    from datetime import timedelta

    from repro_torch.launch.mesh import make_production_mesh
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_",
                                 dir=ROOT / "build"))
    try:
        g = make_production_mesh(str(work / "store"),
                                 timeout=timedelta(seconds=300))
        try:
            check(g.world_size == 1 and g.backend == "nccl" and
                  g.device == torch.device("cuda", 0), f"16: an NCCL group "
                  f"of one rank on cuda:0, got {g}")
            t0 = time.perf_counter()
            a = dist_sharded_scans(g, seed)
            t1 = time.perf_counter()
            b, eng = dist_routed_feed(g, seed)
            t2 = time.perf_counter()
            c = dist_fault_case(g)
            d = dist_restore(g, eng, work)
            del eng
            torch.cuda.empty_cache()
            t3 = time.perf_counter()
        finally:
            g.close()
        e = dist_examples()
        t4 = time.perf_counter()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    b["phase13_feed_ms_per_chunk_median"] = part_res[
        "feed_ms_per_chunk_median"]
    result = {"phase": 16, "case": "distributed, world size 1",
              "nvidia_smi": smi, "backend": "nccl", "world_size": 1,
              "sharded_scans": a, "routed_feed": b, "nan_rows": c,
              "restore": d, "examples": e,
              "seconds": {"16a": t1 - t0, "16b": t2 - t1, "16c_d": t3 - t2,
                          "16e": t4 - t3}}
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase 17: the LM serve path — Qwen2.5-14B at its published width on the
# card, and the CEQL guard over its token stream
# ---------------------------------------------------------------------------

SERVE_ARCH = "qwen2.5-14b"
SERVE_LANES, SERVE_PROMPT, SERVE_TOKENS = 4, 8, 32
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak
PEAK_BF16_FLOP_PER_S = 989e12
BF16_UNIT = 2.0 ** -8       # bf16 keeps 8 significand bits
# bf16 roundings a layer on the path from input to output: the two norms,
# the q/k/v and output projections, RoPE, the scores and probabilities, the
# AV product, the MLP's three projections and product, the residual adds
BF16_ROUNDINGS_PER_LAYER = 16
F32_DECODE_TOL = 5e-4       # tests/test_archs.py: decode ≡ teacher forcing


def decode_bound(model, cfg, lanes: int, index: int):
    """Least seconds of one decode step at position ``index`` for
    ``lanes`` lanes, by bytes and by operations: every weight but the
    embedding read once (the embedding is a gather of ``lanes`` rows), the
    KV cache read up to ``index`` and its new entries written, the logits
    written; two operations a weight per lane, plus the attention's.
    Returns (seconds by bytes, seconds by operations, bytes)."""
    emb = model.embed["embedding"]
    weights = [p for n, p in model.named_parameters()
               if n != "embed.embedding"]
    w_bytes = sum(p.numel() * p.element_size() for p in weights)
    w_matmul = sum(p.numel() for p in weights if p.ndim == 2)
    act = cfg.activation_dtype.itemsize
    L, kv, hd, h = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, \
        cfg.num_heads
    cache = 2 * L * lanes * (index + 1) * kv * hd * act
    nbytes = (w_bytes + lanes * cfg.d_model * emb.element_size() + cache
              + lanes * cfg.padded_vocab * act + 8 * lanes)
    flops = 2 * lanes * w_matmul + 4 * L * lanes * h * hd * (index + 1)
    return nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOP_PER_S, nbytes


def teacher_forcing_err(model, cfg, run) -> dict:
    """The decode's logits (prefill, then each step) against
    ``forward_train`` over the same 40 tokens, on the card."""
    from repro_torch.models import forward_train
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = forward_train(model, cfg, {"tokens": run.fed})[0]
    torch.cuda.synchronize()
    tf_s = time.perf_counter() - t0
    dec = torch.cat([run.prefill_logits, torch.stack(run.step_logits, 1)],
                    dim=1)
    check(tuple(full.shape) == tuple(dec.shape) == (
        SERVE_LANES, SERVE_PROMPT + SERVE_TOKENS, cfg.padded_vocab),
        f"17a: logits of shape {tuple(dec.shape)}")
    check(bool(torch.isfinite(dec).all() and torch.isfinite(full).all()),
          "17a: every logit is finite")
    full, dec = full.float(), dec.float()
    diff = dec - full
    top2 = full.topk(2, dim=-1).values
    return {"max_abs_err": float(diff.abs().max()),
            "logit_max_abs": float(full.abs().max()),
            "logit_rms": float(full.square().mean().sqrt()),
            "rel_rms_err": float(diff.norm() / full.norm()),
            "argmax_agree": float((dec.argmax(-1) == full.argmax(-1))
                                  .float().mean()),
            "min_top2_margin": float((top2[..., 0] - top2[..., 1]).min()),
            "teacher_forcing_ms": 1e3 * tf_s}


def decode_profile(model, cfg, prompt, steps: int = 4) -> dict:
    """Decode steps under ``torch.profiler`` after one warm step: kernels
    a step, the device's busy time (the union of the kernels' intervals)
    against the host clock, and the idle share.  Without device events in
    the trace the device numbers read "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve
    from repro_torch.models import make_serve_step, prefill
    S0 = prompt.shape[1]
    logits, caches = prefill(model, cfg, {"tokens": prompt})
    caches = serve.grow_caches(caches, S0 + steps + 1)
    step = make_serve_step(cfg)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    logits, caches = step(model, tok, caches, S0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(1, steps + 1):
            tok = torch.argmax(logits, dim=-1)[:, None]
            logits, caches = step(model, tok, caches, S0 + t)
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return {"wall_ms_per_step": wall_ms, "kernels_per_step": 0,
                "device_busy_ms_per_step": "not measured",
                "idle_share": "not measured"}
    busy, end = 0.0, -math.inf
    for a, b in spans:                       # union of the intervals, µs
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    busy_ms = busy / 1e3 / steps
    return {"wall_ms_per_step": wall_ms,
            "kernels_per_step": len(spans) / steps,
            "device_busy_ms_per_step": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms}


def phase_serve_model(seed: int, dev: str = "cuda") -> tuple:
    """17a: Qwen2.5-14B at its published width, bf16, on the card: init
    from the seed, prefill of 4 × 8 tokens and 32 greedy decode steps
    through ``repro_torch.launch.serve``'s functions, decode ≡ teacher
    forcing within bf16's rounding; then a 4-layer cut of the same widths
    in float32, where decode ≡ teacher forcing at 5e-4."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_params
    gc.collect()
    torch.cuda.empty_cache()
    mem_start = torch.cuda.memory_allocated() / 1e9
    serve.set_matmul_precision()
    cfg = get_config(SERVE_ARCH)
    shape = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
             cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.param_dtype,
             cfg.dtype, cfg.qkv_bias)
    check(shape == (48, 5120, 40, 8, 128, 13824, 152064, "bfloat16",
                    "bfloat16", True), f"17a: the published shape, {shape}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, _ = init_params(cfg, seed, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    # the matmul weights and embeddings of param_counts, plus the q/k/v
    # biases and the norms' scales
    extra = cfg.num_layers * ((cfg.num_heads + 2 * cfg.num_kv_heads)
                              * cfg.head_dim + 2 * cfg.d_model) + cfg.d_model
    check(n_params == cfg.param_counts()[0] + extra,
          f"17a: {n_params} parameters")
    peak_init = torch.cuda.max_memory_allocated() / 1e9

    prompt = serve.make_prompt(cfg, SERVE_LANES, SERVE_PROMPT, dev,
                               seed=seed + 1)
    # run 1 keeps every step's logits for the checks; run 2 is timed
    checked = serve.generate(model, cfg, prompt, SERVE_TOKENS,
                             keep_logits=True)
    tf = teacher_forcing_err(model, cfg, checked)
    # two orders of summation of the same bf16 computation: independent
    # rounding errors, one unit of 2^-8 each at most, grow as the square
    # root of their count, n = 16 a layer
    tol = (math.sqrt(BF16_ROUNDINGS_PER_LAYER * cfg.num_layers) * BF16_UNIT
           * tf["logit_max_abs"])
    check(tf["max_abs_err"] <= tol, f"17a: bf16 decode ≡ teacher forcing: "
          f"max |Δ| {tf['max_abs_err']} > {tol}")
    checked.step_logits = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = serve.generate(model, cfg, prompt, SERVE_TOKENS)
    peak_run = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [1e3 * s for s in run.step_s]
    prof = decode_profile(model, cfg, prompt)
    med = float(np.median(step_ms))
    bounds = [decode_bound(model, cfg, SERVE_LANES, SERVE_PROMPT + t)
              for t in range(SERVE_TOKENS)]
    b_bytes = float(np.mean([b[0] for b in bounds]))
    b_ops = float(np.mean([b[1] for b in bounds]))
    bound_ms = 1e3 * max(b_bytes, b_ops)
    kv_bytes = (2 * cfg.num_layers * SERVE_LANES
                * (SERVE_PROMPT + SERVE_TOKENS) * cfg.num_kv_heads
                * cfg.head_dim * cfg.activation_dtype.itemsize)
    model_res = {
        "arch": SERVE_ARCH, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "heads": cfg.num_heads,
        "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
        "lanes": SERVE_LANES, "prompt": SERVE_PROMPT,
        "tokens": SERVE_TOKENS, "params": n_params,
        "param_GB": param_bytes / 1e9, "kv_cache_MB": kv_bytes / 1e6,
        "init_s": init_s, "mem_at_start_GB": mem_start,
        "peak_mem_GB_init": peak_init, "peak_mem_GB_decode": peak_run,
        "prefill_ms": 1e3 * run.prefill_s,
        "prefill_ms_first_run": 1e3 * checked.prefill_s,
        "decode_ms_per_step_median": med,
        "decode_ms_per_step": step_ms,
        "decode_ms_spread": {"min": min(step_ms), "max": max(step_ms),
                             "p10": float(np.percentile(step_ms, 10)),
                             "p90": float(np.percentile(step_ms, 90))},
        "decode_ms_first_run_median": float(np.median(
            [1e3 * s for s in checked.step_s])),
        "tokens_per_s": SERVE_LANES / (med / 1e3),
        "decode_bound_ms": bound_ms,
        "decode_bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "decode_bound_GB": float(np.mean([b[2] for b in bounds])) / 1e9,
        "bound_share": bound_ms / med, "profile": prof,
        "rerun_tokens_equal": bool(np.array_equal(run.tokens,
                                                  checked.tokens)),
        "teacher_forcing": dict(tf, tolerance=tol,
                                tolerance_rule="sqrt(16 * layers) * 2^-8 "
                                "* max |logit|")}
    del model, checked
    gc.collect()
    torch.cuda.empty_cache()

    # the same widths, 4 layers, in float32: tells a fault from bf16 noise
    cut = dataclasses.replace(cfg, num_layers=4, dtype="float32",
                              param_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    model, _ = init_params(cut, seed, dev)
    cut_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    cut_run = serve.generate(model, cut, prompt, SERVE_TOKENS,
                             keep_logits=True)
    cut_tf = teacher_forcing_err(model, cut, cut_run)
    check(cut_tf["max_abs_err"] < F32_DECODE_TOL, f"17a cut: float32 decode "
          f"≡ teacher forcing: {cut_tf['max_abs_err']} ≥ {F32_DECODE_TOL}")
    model_res["cut"] = {
        "case": "the 4-layer cut of the published widths, float32",
        "layers": 4, "param_GB": cut_bytes / 1e9,
        "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
        "decode_ms_per_step_median": float(np.median(
            [1e3 * s for s in cut_run.step_s])),
        "teacher_forcing": dict(cut_tf, tolerance=F32_DECODE_TOL)}
    del model, cut_run
    gc.collect()
    torch.cuda.empty_cache()
    return model_res, run


def guard_service(q, device, directory, raws):
    """The launcher's ``--service`` guard on ``device`` over ``raws``:
    per-position counts from the emission log, alerts, launches, the
    device thread's step spans, the engine and the encoded chunks."""
    from repro_torch.launch import serve
    alerts = []
    svc = serve.make_guard_service(q, SERVE_LANES, device, str(directory),
                                   sinks=[lambda c, h: alerts.extend(h)])
    spans, encoded, _ = instrument(svc, svc.engine)
    counters = reset_launches()
    for r in raws:
        svc.submit(r, block=True, timeout=120.0)
    svc.drain(pad=True)
    launches = read_launches(counters)
    chunk = svc.engine.chunk_len
    counts = np.zeros(svc.metrics.chunks * chunk, np.int64)
    for rec in svc.runner.log.records:
        for idx, v in rec["counts"]:
            counts[rec["chunk"] * chunk + idx[0]] = v
    chunks = svc.metrics.chunks
    svc.close()
    return {"counts": counts[:len(raws)], "pad": counts[len(raws):],
            "alerts": alerts, "launches": launches, "chunks": chunks,
            "step_ms": ms_list(spans["step"]), "engine": svc.engine,
            "encoded": encoded}


def phase_serve_guard(run, work: Path, dev: str = "cuda") -> dict:
    """17b: the guard over 17a's 4 × 32 token events: the service on the
    card (one lane_route and one fused_scan launch a chunk) ≡ the same
    service on the CPU ≡ the host ``PartitionedEngine``; then both kernels
    ≡ plain on one more chunk of the guard's engine, with times and
    bounds at the guard's shape."""
    from repro_torch.core import Event, compile_query
    from repro_torch.core.engine import Engine
    from repro_torch.core.partition import PartitionedEngine
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    raws = [{"type": "TOK", "lane": lane, "logp": float(run.logp[lane, t]),
             "tok": int(run.tokens[lane, t])}
            for t in range(SERVE_TOKENS) for lane in range(SERVE_LANES)]
    q = compile_query(serve.DEFAULT_GUARD)
    pe = PartitionedEngine(lambda: Engine(q.cea, window=q.query.window),
                           q.query.partition_by)
    host = np.array([len(pe.process(Event("TOK", {
        k: v for k, v in r.items() if k != "type"}))) for r in raws])
    card = guard_service(q, dev, work / "guard_card", raws)
    cpu = guard_service(q, "cpu", work / "guard_cpu", raws)
    check(same(card["counts"], host) and same(cpu["counts"], host),
          "17b: per-position counts of the card's service ≡ the CPU "
          "service's ≡ the host PartitionedEngine's")
    check(not card["pad"].any() and not cpu["pad"].any(), "17b: pads inert")
    check(card["alerts"] == cpu["alerts"] and len(card["alerts"]) == int(
        (host > 0).sum()), "17b: the same alerts, one a matching position")
    n = card["chunks"]
    want = {k: 0 for k in card["launches"]}
    want.update(lane_route=n, fused_scan=n)
    check(card["launches"] == want, f"17b launched {card['launches']}, "
          f"expected one lane_route and one fused_scan a chunk")
    check(not any(cpu["launches"].values()), "17b: the CPU service "
          "launches no kernel")
    check(int(host.max()) < EXACT_LIMIT, "17b: counts below 2^24")

    # both kernels ≡ plain on one more chunk of the card's guard engine
    eng = card["engine"]
    (attrs_h, keys_h), _ = card["encoded"][-1]
    attrs = attrs_h.to(dev)
    keys_dev = ref.key_bits(keys_h).to(dev)
    st = eng.state

    def route(impl="fused"):
        return ops.lane_route(keys_dev, st["lane_keys"], st["lane_last"],
                              chunk_idx=eng._chunk_idx, cap=eng.lane_cap,
                              impl=impl)
    got = route()
    plain, s_plain = host_clock(lambda: route("ref"))
    check(route_equal(got, plain), "17b: lane_route kernel ≡ plain")
    r_tb, r_to, _ = route_bound(eng.chunk_len, eng.num_lanes)
    ops_ = part_step_operands(eng, attrs, keys_dev)
    m_k, c_k = part_fused(eng, ops_, clone_state(st["C"]))
    m_p, c_p = part_fused(eng, ops_, clone_state(st["C"]), "ref")
    check(same(m_k, m_p) and same(c_k, c_p), "17b: fused_scan ≡ plain")
    st_t = clone_state(st["C"])
    f_tb, f_to, _ = part_fused_bound(eng, ops_)
    return {
        "events": len(raws), "chunks": n, "chunk_len": eng.chunk_len,
        "lanes": eng.num_lanes, "matches": int(host.sum()),
        "alerts": len(card["alerts"]), "launches": card["launches"],
        "step_ms_median": float(np.median(card["step_ms"])),
        "step_ms": card["step_ms"],
        "cpu_step_ms_median": float(np.median(cpu["step_ms"])),
        "lane_route_ms": cuda_ms(route, reps=20),
        "lane_route_plain_ms": 1e3 * s_plain,
        "lane_route_bound_ms": 1e3 * max(r_tb, r_to),
        "lane_route_bound_by": "bytes" if r_tb >= r_to else "operations",
        "lane_route_max_abs_err": route_err(got, plain),
        "fused_scan_ms": cuda_ms(lambda: part_fused(eng, ops_, st_t),
                                 reps=20),
        "fused_scan_plain_ms": cuda_ms(
            lambda: part_fused(eng, ops_, st_t, "ref"), reps=3),
        "fused_scan_bound_ms": 1e3 * max(f_tb, f_to),
        "fused_scan_bound_by": "bytes" if f_tb >= f_to else "operations",
        "fused_scan_max_abs_err": max(max_abs_err(m_k, m_p),
                                      max_abs_err(c_k, c_p))}


def serve_subprocesses(work: Path) -> dict:
    """17c: the example's --service leg and the launcher's smoke run with
    --service, on the card, as subprocesses at once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = {
        "example": [sys.executable,
                    str(ROOT / "examples" / "torch_serve_monitored.py"),
                    "--service"],
        "launcher": [sys.executable, "-m", "repro_torch.launch.serve",
                     "--arch", SERVE_ARCH, "--smoke", "--service",
                     "--service-dir", str(work / "launcher_svc")]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(cmd, env=env, cwd=ROOT, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, cmd in runs.items()}
    out, secs = {}, {}
    try:
        for k, p in procs.items():
            o, e = p.communicate(timeout=300)
            secs[k] = time.perf_counter() - t0
            check(p.returncode == 0, f"17c: {k} exited {p.returncode}: "
                  f"{e[-2000:]}")
            out[k] = o.splitlines()
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    ex = out["example"]
    check(len(ex) == 3 and ex[1].startswith("service ≡ host baseline") and
          "compile_count=1" in ex[1] and
          ex[2].startswith("overflow self-heal"), f"17c: example: {ex}")
    la = out["launcher"]
    check(len(la) == 1 and "guardrail alerts across" in la[0] and
          "compile_count=1" in la[0], f"17c: launcher: {la}")
    return {"example": ex, "launcher": la, "seconds": secs}


def phase_serve(seed: int, smi: str) -> dict:
    """Phase 17: the LM serve path (17a model, 17b guard, 17c the example
    and the launcher), scratch directories under build/."""
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_",
                                 dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        model_res, run = phase_serve_model(seed)
        t1 = time.perf_counter()
        guard = phase_serve_guard(run, work)
        t2 = time.perf_counter()
        sub = serve_subprocesses(work)
        t3 = time.perf_counter()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    guard["decode_ms_per_step_median"] = model_res[
        "decode_ms_per_step_median"]
    result = {"phase": 17, "case": "the LM serve path: Qwen2.5-14B at its "
              "published width, bf16, and its token stream's guard",
              "nvidia_smi": smi, "model": model_res, "guard": guard,
              "subprocesses": sub,
              "seconds": {"17a": t1 - t0, "17b": t2 - t1, "17c": t3 - t2}}
    emit(result)
    return result


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    # phase 14b's subprocesses: one crash-recovery run over a directory
    parser.add_argument("--crash-worker", metavar="DIR",
                        help=argparse.SUPPRESS)
    parser.add_argument("--service-worker", metavar="DIR",
                        help=argparse.SUPPRESS)
    parser.add_argument("--crash-after", type=int, default=-1,
                        help=argparse.SUPPRESS)
    # phase 15c's subprocess: one fleet crash-recovery run over a directory
    parser.add_argument("--fleet-worker", metavar="DIR",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit("chip_smoke.py runs from a checkout of the repository: "
                 "src/repro_torch is missing")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.crash_worker or args.service_worker or args.fleet_worker:
        run = (crash_run if args.crash_worker else fleet_kill_run
               if args.fleet_worker else service_kill_run)
        emit(run(args.crash_worker or args.service_worker
                 or args.fleet_worker, args.crash_after, args.seed))
        return

    t_main = time.perf_counter()
    spans = {}

    def phase(name, fn, *a):
        """One phase, its wall-clock seconds kept under ``name``."""
        t0 = time.perf_counter()
        out = fn(*a)
        spans[name] = time.perf_counter() - t0
        return out

    seed = args.seed
    smi, launch_floor_ms = phase("0 build, card", phase_card)
    main_res, main_run = phase("1 main", phase_main, seed)
    phase("2 host", phase_host, seed)
    phase("3 time windows", phase_time, seed)
    phase("4 LAST, per-lane offsets", phase_last_lanes, seed)
    enum_res = phase("5 arena", phase_enum, seed)
    phase("6 arena, stock Q1 Q3", phase_enum_time, seed)
    phase("7 arena, LAST, K5", phase_enum_shapes, seed)
    unf_res = phase("8 unfused", phase_unfused, seed, main_run)
    del main_run
    packed_res = phase("9 packed", phase_packed, seed)
    phase("10 edges", phase_edges, seed)
    nine_res = phase("11 nine queries", phase_nine, seed)
    wide_res = phase("12 arena at 1024", phase_enum_wide, seed)
    part_res, part_arena = phase("13a partitioned", phase_part, seed)
    exact_res = phase("13b partitioned exactness", phase_part_exact, seed)
    svc_res, kill_res = phase("14 service, recovery", phase_runtime, seed)
    fleet_res, fleet_arena, _, bits16 = phase("15 fleet", phase_fleets, seed)
    dist_res = phase("16 distributed", phase_distributed, seed, part_res,
                     smi)
    dist_a, dist_b = dist_res["sharded_scans"], dist_res["routed_feed"]
    serve_res = phase("17 serve", phase_serve, seed, smi)
    guard17 = serve_res["guard"]
    emit({"phase_seconds": spans,
          "total_s": time.perf_counter() - t_main})
    unf = unf_res["kernels"]
    fleet15_err = max(v["max_abs_err"] for v in
                      list(fleet_res["kernels"].values())
                      + [bits16["kernel"]])
    emit({"kernels": [{
        "name": "fused_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_scan.cu",
        "replaces": "src/repro/kernels/fused_scan.py:215",
        "launches": main_res["launches"],
        "max_abs_err": max(main_res["max_abs_err"], fleet15_err,
                           guard17["fused_scan_max_abs_err"]),
        "max_abs_diff": max(main_res["max_abs_err"], fleet15_err,
                            guard17["fused_scan_max_abs_err"]),
        "ms": main_res["kernel_ms_per_chunk"],
        "plain_ms": main_res["plain_ms_per_chunk"],
        "bound_ms": main_res["bound_ms"],
        "bound_by": main_res["bound_by"],
        "library_ms": None,
        "phase9_ms": packed_res["fused_scan_ms"],
        "phase9_n_split": packed_res["fused_scan_n_split"],
        "phase11_ms": nine_res["fused_scan_ms"],
        "phase11_n_split": nine_res["fused_scan_n_split"],
        "phase13_ms": part_res["fused_scan_ms"],
        "phase13_bound_ms": part_res["fused_scan_bound_ms"],
        "phase13_n_split": part_res["fused_scan_n_split"],
        "phase14_launches": svc_res["launches"]["fused_scan"],
        "phase15_launches": fleet_res["launches"]["fused_scan"],
        "phase16_launches": dist_a["launches"]["fused_scan"]
        + dist_b["launches"]["fused_scan"],
        "phase16_sharded_ms": dist_a["sharded_pipeline_ms"],
        "phase16_unsharded_ms": dist_a["unsharded_pipeline_ms"],
        "phase17_launches": guard17["launches"]["fused_scan"],
        "phase17_ms": guard17["fused_scan_ms"],
        "phase17_plain_ms": guard17["fused_scan_plain_ms"],
        "phase17_bound_ms": guard17["fused_scan_bound_ms"],
        "phase17_max_abs_err": guard17["fused_scan_max_abs_err"],
        "phase15_buckets": {k: {x: v[x] for x in (
            "S", "NQ", "k", "state_bucket", "n_split", "kernel_ms",
            "plain_ms", "bound_ms", "bound_by")}
            for k, v in list(fleet_res["kernels"].items())
            + [("bits16", bits16["kernel"])]}}, {
        "name": "arena_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/arena_update.cu",
        "replaces": "src/repro/kernels/arena_update.py:88",
        "launches": enum_res["launches"]["arena_update"],
        "max_abs_err": max(enum_res["max_abs_err"],
                           wide_res["max_abs_err"],
                           part_arena["max_abs_err"],
                           fleet_arena["max_abs_err"]),
        "ms": enum_res["kernel_ms_per_chunk"],
        "plain_ms": enum_res["plain_ms_per_chunk"],
        "bound_ms": enum_res["bound_ms"],
        "bound_by": enum_res["bound_by"],
        "library_ms": None,
        "dense_ms": enum_res["dense_kernel_ms_per_chunk"],
        "dense_bound_ms": enum_res["dense_bound_ms"],
        "phase12_ms": wide_res["kernel_ms_per_chunk"],
        "phase12_bound_ms": wide_res["bound_ms"],
        "phase12_launches": wide_res["launches"]["arena_update"],
        "phase13_ms": part_arena["store_kernel_ms"],
        "phase13_bound_ms": part_arena["store_bound_ms"],
        "phase13_launches": part_arena["launches"]["arena_update"],
        "phase14_launches": kill_res["launches"]["arena_update"],
        "phase15_launches": fleet_arena["launches"]["arena_update"]}, {
        "name": "bitvector", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitvector.cu",
        "replaces": "src/repro/kernels/bitvector.py:45",
        "launches": unf_res["feed_launches"]["bitvector"],
        "max_abs_err": unf["bitvector"]["max_abs_err"],
        "ms": unf["bitvector"]["ms"],
        "plain_ms": unf["bitvector"]["plain_ms"],
        "bound_ms": unf["bitvector"]["bound_ms"],
        "bound_by": unf["bitvector"]["bound_by"],
        "library_ms": None, "launch_floor_ms": launch_floor_ms,
        "device_ms": unf["bitvector"]["device_ms"],
        "host_call_ms": unf["bitvector"]["host_call_ms"]}, {
        "name": "cea_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cea_scan.cu",
        "replaces": "src/repro/kernels/cea_scan.py:195",
        "launches": unf_res["classify_scan_launches"]["cea_scan"],
        "max_abs_err": unf["cea_scan"]["max_abs_err"],
        "ms": unf["cea_scan"]["ms"],
        "plain_ms": unf["cea_scan"]["plain_ms"],
        "bound_ms": unf["cea_scan"]["bound_ms"],
        "bound_by": unf["cea_scan"]["bound_by"],
        "library_ms": None,
        "phase16_launches": dist_a["cea_scan_launches"]["cea_scan"],
        "phase16_sharded_ms": dist_a["sharded_cea_scan_ms"],
        "phase16_unsharded_ms": dist_a["unsharded_cea_scan_ms"]}, {
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
        "phase11_n_split": nine_res["cea_scan_multi_n_split"]}, {
        "name": "lane_route", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lane_route.cu",
        "replaces": "src/repro/vector/partitioned.py:182 (lax.scan, "
                    "not a Pallas kernel)",
        "launches": part_res["launches"]["lane_route"],
        "max_abs_err": max(part_res["lane_route_max_abs_err"],
                           exact_res["lane_route_max_abs_err"],
                           guard17["lane_route_max_abs_err"]),
        "ms": part_res["lane_route_ms"],
        "plain_ms": part_res["lane_route_plain_ms"],
        "bound_ms": part_res["lane_route_bound_ms"],
        "bound_by": part_res["lane_route_bound_by"],
        "library_ms": None,
        "chunk1_ms": part_res["lane_route_ms_chunk1"],
        "chunk1_plain_ms": part_res["lane_route_plain_ms_chunk1"],
        "phase13b_checks": exact_res["router_checks"],
        "phase14_launches": svc_res["launches"]["lane_route"],
        "phase16_launches": dist_b["launches"]["lane_route"],
        "phase17_launches": guard17["launches"]["lane_route"],
        "phase17_ms": guard17["lane_route_ms"],
        "phase17_plain_ms": guard17["lane_route_plain_ms"],
        "phase17_bound_ms": guard17["lane_route_bound_ms"],
        "phase17_max_abs_err": guard17["lane_route_max_abs_err"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
