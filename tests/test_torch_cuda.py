"""The Hopper kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one; none imports
JAX.  Run them on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance 0: counts are f32 integers, exact below 2^24 in any order of
summation, and the arena builder's records, roots and cells are int32 node
ids, so kernel and plain version agree bit for bit.
"""
import random

import numpy as np
import pytest
import torch

from repro_torch.data import StreamSpec, random_stream
from repro_torch.kernels import (arena_update, bitvector, cea_scan,
                                 fused_scan, lane_route)
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import window as wkern
from repro_torch.vector import StreamingVectorEngine, VectorEngine
from repro_torch.vector import tecs_arena

from _route_cases import ROUTE_T, dup_tables, later_holders, route_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels are CUDA C++ "
                    "and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def random_tables(rng, S, C, A, k, NQ, tables="dense"):
    """Random tables whose rows hold at most one 1, so run counts cannot
    grow past 2^24 however wide the window; branching tables are covered by
    the real queries of the streaming test and of chip_smoke.py.

    ``tables="dense"``: any column in-degree, and class 0's state 1 the
    target of SPARSE_CAP + 1 states, so the narrow builds must keep the
    dense product.  ``"sparse"``: at most SPARSE_CAP sources a column in
    the 32-state build (3 elsewhere) and 1 or 2 final states a query, the
    first the target of the seeded state 1 in every class, so the 32-state
    build takes the sparse step and every lane matches."""
    specs = tuple((int(rng.integers(0, A)), int(rng.integers(0, 6)),
                   float(np.float32(rng.normal()))) for _ in range(k))
    class_of = rng.integers(0, C, 1 << k).astype(np.int32)
    M = np.zeros((C, S, S), np.float32)
    cap = fused_scan.SPARSE_CAP
    most = fused_scan.table_cap(S) or 3
    # the sparse tables' first final state (no draw for the dense ones)
    first = int(rng.integers(1, S)) if tables == "sparse" else 0
    for c in range(C):
        deg = np.zeros(S, np.int64)
        for s in range(1, S):
            if tables == "sparse" and s == 1:
                u = first                 # every class: a seed reaches it
            elif rng.random() < 0.8:
                free = [u for u in range(1, S)
                        if tables == "dense" or deg[u] < most]
                if not free:
                    continue
                u = rng.choice(free)
            else:
                continue
            M[c, s, u] = 1.0
            deg[u] += 1
    if tables == "dense":
        M[0, :cap + 1] = 0.0
        M[0, :cap + 1, 1] = 1.0
        finals = (rng.random((NQ, S)) < 0.4).astype(np.float32)
    else:
        finals = np.zeros((NQ, S), np.float32)
        finals[:, first] = 1.0
        finals[1::2, rng.integers(1, S)] = 1.0
    finals[:, 0] = 0.0
    init = np.zeros(S, np.float32)
    init[1] = 1.0
    return specs, class_of, M, finals, init


def takes_sparse_step(tables, S):
    """The 32-state build takes the sparse step on tables within the cap;
    the others keep the dense product."""
    return tables == "sparse" and fused_scan.table_cap(S) > 0


def equal(a, b):
    if isinstance(a, dict):
        return all(torch.equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


# (S, NQ, W-or-size, timed): the 8/16/32-state builds, rings too large for
# shared memory (W·S·4 > 227 KB), time windows, several queries; the wide
# build (S > 32) and query groups past 8
CASES = [(5, 1, 7, False), (9, 2, 31, False), (26, 3, 100, False),
         (15, 1, 4000, False), (7, 2, 9.0, True), (13, 1, 40.0, True),
         (40, 9, 31, False), (70, 11, 9.0, True), (20, 17, 12, False),
         (28, 2, 2100, False), (24, 2, 9.0, True)]


@pytest.mark.parametrize("S,NQ,win,timed", CASES)
@pytest.mark.parametrize("latest,consume", [(False, False), (True, True),
                                            (True, False), (False, True)])
@pytest.mark.parametrize("tables", ["dense", "sparse"])
def test_kernel_matches_plain_version(dev, S, NQ, win, timed, latest,
                                      consume, tables):
    rng = np.random.default_rng(S * 31 + NQ)
    B, T, A, k, C = 37, 64, 3, 5, 6
    specs, class_of, M, finals, init = random_tables(rng, S, C, A, k, NQ,
                                                     tables)
    attrs = rng.normal(size=(T, B, A)).astype(np.float32)
    attrs[rng.random((T, B, A)) < 0.05] = np.nan
    ts = np.cumsum(rng.integers(0, 3, (T, B)), axis=0).astype(np.float32)
    window = (wkern.DeviceWindow.time(win, max_window_events=48) if timed
              else wkern.DeviceWindow.events(win))
    c0 = wkern.init_state(window, B, S, dev)
    ring = c0["C"] if timed else c0
    ring.copy_(torch.from_numpy(
        (rng.random(ring.shape) < 0.05).astype(np.float32)))
    start = rng.integers(0, 5000, B)
    start[:5] = 0
    consume_sq = None
    if consume:
        consume_sq = torch.zeros((NQ, S), device=dev)
        consume_sq[0] = 1.0
        consume_sq[-1, S // 2:] = 1.0   # a query of the last group
    latest_q = None
    if latest:
        latest_q = torch.zeros(NQ, device=dev)
        latest_q[-1] = 1.0
        latest_q[NQ // 2] = 1.0
    args = (torch.from_numpy(attrs).to(dev), specs,
            torch.from_numpy(class_of).to(dev),
            ops.class_indicator(class_of, C).to(dev),
            torch.from_numpy(M).to(dev), torch.from_numpy(finals).to(dev))
    kw = dict(init_mask=torch.from_numpy(init).to(dev), window=window,
              event_ts=torch.from_numpy(ts).to(dev) if timed else None,
              start_pos=torch.from_numpy(start).to(dev),
              valid_counts=torch.from_numpy(
                  rng.integers(0, T + 1, B)).to(dev),
              return_trace=True, latest_q=latest_q, consume_sq=consume_sq)
    launches = fused_scan.KERNEL.launches
    sparse = fused_scan.KERNEL.sparse_launches
    got = ops.cer_pipeline(*args, c0, impl="fused", **kw)
    torch.cuda.synchronize()
    assert fused_scan.KERNEL.launches == launches + 1
    assert fused_scan.KERNEL.sparse_launches == sparse + takes_sparse_step(
        tables, S)
    # the 4000-slot ring does not fit one block: a sum-only call splits
    # it over two blocks, LAST or CONSUME reads it in global memory
    if S in (15, 28):
        want_plan = (False, 1) if latest or consume else (True, 2)
    else:
        want_plan = (True, 1)
    assert fused_scan.KERNEL.last_plan == want_plan
    want = ops.cer_pipeline(*args, c0, impl="ref", **kw)
    for g, w in zip(got, want):
        assert equal(g, w)
    assert float(got[0].max()) < 2 ** 24


# (S, NQ, W, eps): rings that no split of 2, 3 or 5 divides, NQ 1, 8 and
# past 8, the four state builds; eps None is a time window of rate bound W
SPLIT_CASES = [(5, 1, 31, 30), (9, 8, 23, 9), (26, 3, 17, 16),
               (7, 1, 37, None), (13, 8, 29, None), (45, 10, 23, 9),
               (33, 9, 29, None), (30, 8, 29, None)]


@pytest.mark.parametrize("S,NQ,W,eps", SPLIT_CASES)
@pytest.mark.parametrize("split", [2, 3, 5])
@pytest.mark.parametrize("tables", ["dense", "sparse"])
def test_forced_split_matches_plain_version(dev, S, NQ, W, eps, split,
                                            tables):
    """Each block keeps a share of the ring: counts, trace, ring, ts ring
    and ovf equal the plain version exactly, with the seed and expiry slots
    on the first and last slot of every segment."""
    rng = np.random.default_rng(S * 13 + NQ + split)
    T, A, k, C = 64, 3, 5, 6
    timed = eps is None
    specs, class_of, M, finals, init = random_tables(rng, S, C, A, k, NQ,
                                                     tables)
    use_smem, n = fused_scan.plan_ring(W, S, timed, 10 ** 6, latest=False,
                                       consume=False, split=split)
    segs = fused_scan.segments(W, n)
    # lane starts: start 0; each segment's first and last slot as the seed
    # slot (jm) at t = 0, and as the expiry slot (em = jm - eps - 1)
    starts = [0]
    for a, b in segs:
        for w in (a, b - 1):
            starts += [w, w + W * 7919]
            if not timed:
                starts.append(w + eps + 1)
    B = len(starts) + 6
    start = np.concatenate([starts, rng.integers(0, 10 ** 6, 6)])
    valid = rng.integers(0, T + 1, B)
    valid[:len(starts)] = T
    valid[-2:] = 0                                   # dead lanes
    attrs = rng.normal(size=(T, B, A)).astype(np.float32)
    attrs[rng.random((T, B, A)) < 0.05] = np.nan
    ts = np.cumsum(rng.integers(0, 3, (T, B)), axis=0).astype(np.float32)
    if timed:
        # lane 1 starts on the last segment's first slot and its events
        # share one timestamp: nothing expires, so the first overwrite, at
        # t = W, latches ovf in that segment alone
        start[1] = segs[-1][0]
        ts[:, 1] = 5.0
        window = wkern.DeviceWindow("time", 6.0, ring=W)
    else:
        window = wkern.DeviceWindow("events", float(eps), ring=W)
    c0 = wkern.init_state(window, B, S, dev)
    ring = c0["C"] if timed else c0
    ring.copy_(torch.from_numpy(
        (rng.random(ring.shape) < 0.05).astype(np.float32)))
    args = (torch.from_numpy(attrs).to(dev), specs,
            torch.from_numpy(class_of).to(dev), None,
            torch.from_numpy(M).to(dev), torch.from_numpy(finals).to(dev))
    kw = dict(init_mask=torch.from_numpy(init).to(dev), window=window,
              event_ts=torch.from_numpy(ts).to(dev) if timed else None,
              start_pos=torch.from_numpy(start).to(dev),
              valid_counts=torch.from_numpy(valid).to(dev),
              return_trace=True)
    launches = fused_scan.KERNEL.launches
    sparse = fused_scan.KERNEL.sparse_launches
    got = ops.cer_pipeline(*args, c0, impl="fused", split=split, **kw)
    torch.cuda.synchronize()
    assert fused_scan.KERNEL.launches == launches + 1
    assert fused_scan.KERNEL.sparse_launches == sparse + takes_sparse_step(
        tables, S)
    assert fused_scan.KERNEL.last_plan == (True, n) and n > 1
    want = ops.cer_pipeline(*args, c0, impl="ref", **kw)
    for g, w in zip(got, want):
        assert equal(g, w)
    if timed:
        assert bool(got[1]["ovf"][1])
    assert float(got[0][:, -2:].abs().max()) == 0.0   # dead lanes emit 0
    assert float(got[0].max()) > 0 and float(got[0].max()) < 2 ** 24


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("tables", ["dense", "sparse"])
@pytest.mark.parametrize("S", [15, 28])
def test_forced_split_in_global_memory_matches_plain_version(dev, split,
                                                             tables, S):
    """A forced split whose share does not fit shared memory (480 KB a
    lane at 15 states) reads its segment of the ring in global memory."""
    rng = np.random.default_rng(split)
    NQ, W, eps, B, T, A, k, C = 2, 8000, 7990, 9, 32, 3, 5, 6
    specs, class_of, M, finals, init = random_tables(rng, S, C, A, k, NQ,
                                                     tables)
    c0 = torch.from_numpy((rng.random((B, W, S)) < 0.01).astype(
        np.float32)).to(dev)
    args = (torch.from_numpy(rng.normal(size=(T, B, A)).astype(
                np.float32)).to(dev), specs,
            torch.from_numpy(class_of).to(dev), None,
            torch.from_numpy(M).to(dev), torch.from_numpy(finals).to(dev),
            c0)
    kw = dict(init_mask=torch.from_numpy(init).to(dev), epsilon=eps,
              start_pos=torch.from_numpy(rng.integers(0, 10 ** 6, B)).to(
                  dev))
    sparse = fused_scan.KERNEL.sparse_launches
    got = ops.cer_pipeline(*args, impl="fused", split=split, **kw)
    torch.cuda.synchronize()
    assert fused_scan.KERNEL.last_plan == (False, split)
    assert fused_scan.KERNEL.sparse_launches == sparse + takes_sparse_step(
        tables, S)
    want = ops.cer_pipeline(*args, impl="ref", **kw)
    for g, w in zip(got, want):
        assert equal(g, w)


def test_streaming_engine_on_card(dev):
    """Chunks through the kernel equal the plain route and the host-free
    CPU run; the library is loaded once."""
    query = "SELECT * FROM S WHERE A1 ; A2+ ; A3 WITHIN 50 events"
    B, T = 8, 32
    streams = [random_stream(StreamSpec(["A1", "A2", "A3"], seed=b), 4 * T)
               for b in range(B)]
    runs, states = {}, {}
    for name, device, impl in (("kernel", None, None),
                               ("plain", None, "ref"),
                               ("cpu", "cpu", None)):
        se = StreamingVectorEngine(VectorEngine(query, device=device,
                                                impl=impl), T, B)
        runs[name] = [se.feed([s[i * T:(i + 1) * T] for s in streams])
                      for i in range(4)]
        states[name] = se.state.cpu()
        if name == "kernel":
            assert se.compile_count == 1
    for name in ("plain", "cpu"):
        for (ck, hk), (cp, hp) in zip(runs["kernel"], runs[name]):
            np.testing.assert_array_equal(ck, cp)
            assert hk == hp
        assert torch.equal(states["kernel"], states[name])


def test_router_raises_on_what_the_kernel_refuses(dev):
    """Past 512 states and forced splits with LAST, CONSUME or past the
    ring are refused before any launch; 40 states and 9 queries run."""
    B, T = 2, 4
    rng = np.random.default_rng(0)
    # 40 states and 9 queries equal the plain version; past 512 states
    # is refused
    for S, NQ in ((40, 9), (513, 1)):
        specs, class_of, M, finals, init = random_tables(rng, S, 3, 2, 2,
                                                         NQ)
        args = (torch.from_numpy(rng.normal(size=(T, B, 2)).astype(
                    np.float32)).to(dev), specs,
                torch.from_numpy(class_of).to(dev), None,
                torch.from_numpy(M).to(dev),
                torch.from_numpy(finals).to(dev),
                torch.zeros((B, 8, S), device=dev))
        kw = dict(init_mask=torch.from_numpy(init).to(dev), epsilon=3)
        if S > 512:
            with pytest.raises(ValueError, match="det states"):
                ops.cer_pipeline(*args, **kw)
            continue
        got = ops.cer_pipeline(*args, impl="fused", **kw)
        want = ops.cer_pipeline(*args, impl="ref", **kw)
        for g, w in zip(got, want):
            assert equal(g, w)
    # a forced split with LAST or CONSUME, or past the ring, launches nothing
    S, NQ = 6, 2
    specs, class_of, M, finals, init = random_tables(rng, S, 3, 2, 2, NQ)
    launches = fused_scan.KERNEL.launches
    for kw, reason in ((dict(latest_q=torch.ones(NQ, device=dev)), "LAST"),
                       (dict(consume_sq=torch.ones((NQ, S), device=dev)),
                        "CONSUME"),
                       (dict(split=9), "1..8")):
        with pytest.raises(ValueError, match=reason):
            ops.cer_pipeline(
                torch.zeros((T, B, 2), device=dev), specs,
                torch.from_numpy(class_of).to(dev), None,
                torch.from_numpy(M).to(dev),
                torch.from_numpy(finals).to(dev),
                torch.zeros((B, 8, S), device=dev),
                init_mask=torch.from_numpy(init).to(dev), epsilon=3,
                **{"split": 2, **kw})
    assert fused_scan.KERNEL.launches == launches


# ---------------------------------------------------------------------------
# the block tECS builder
# ---------------------------------------------------------------------------

STOCK_Q1 = """SELECT * FROM S
    WHERE SELL AS msft ; BUY AS oracle ; BUY AS csco ; SELL AS amat
    FILTER msft[name = 'MSFT'] AND oracle[name = 'ORCL'] AND
    csco[name = 'CSCO'] AND amat[name = 'AMAT']
    WITHIN 30000 [stock_time]"""
# (query, max_window_events): S = 4, 9 and 26, i.e. the 8/16/32 buckets;
# a count and a time window
ARENA_QUERIES = [
    ("SELECT * FROM S WHERE A1 ; A2+ ; A3 WITHIN 20 events", None),
    (STOCK_Q1, 40),
    ("SELECT * FROM S WHERE A1 ; A2+ ; A3 ; A4+ ; A5 WITHIN 12 events",
     None),
]


def arena_operands(dev, query, mwe, consume, B, T, seed):
    """Random chunk operands for the builder of ``query``'s tables (a
    query or a constructed engine): a sparse chunk-start cell table,
    classes, hits only on live steps, a quarter of the lanes at start 0 and
    some lanes dead."""
    ve = (VectorEngine(query, max_window_events=mwe, device=dev)
          if isinstance(query, str) else query)
    at = ve.arena_tables()
    cap = 1 << 12
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
    kw = {}
    if ve.window.is_time:
        kw["expire"] = torch.from_numpy(rng.random((T, B, W)) < 0.1).to(dev)
    if consume:
        kw["consume"] = torch.from_numpy(rng.random((T, B, S)) < 0.05).to(
            dev)
    args = (cells0, torch.from_numpy(cls).to(dev),
            torch.from_numpy(hits).to(dev), torch.from_numpy(start).to(dev),
            torch.from_numpy(valid).to(dev))
    kw.update(lay=lay, ptab=tecs_arena._ptab(at, dev),
              finals_sq=tecs_arena._finals(at, dev))
    return args, kw, lay


@pytest.mark.parametrize("query,mwe", ARENA_QUERIES)
@pytest.mark.parametrize("consume,n_seg", [(False, 1), (True, 1),
                                           (False, 2)])
def test_arena_kernel_matches_plain_version(dev, query, mwe, consume,
                                            n_seg):
    B, T = 13, 96
    args, kw, lay = arena_operands(dev, query, mwe, consume, B, T,
                                   seed=len(query) + 3 * consume + n_seg)
    launches = arena_update.DENSE.launches
    got = ops.arena_block_update(*args, n_seg=n_seg, impl="fused", **kw)
    torch.cuda.synchronize()
    assert arena_update.DENSE.launches == launches + 1
    want = ops.arena_block_update(*args, n_seg=n_seg, impl="ref", **kw)
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    assert int(got[1].sum()) > 0


# nine standing queries of the Fig. 8 shape (63 states, 9 queries) and a
# pack padded to 512 states and 16 query slots over few classes
NINE = ("A1 ; A2 ; A3", "B1 ; B2 ; B3", "B4 ; B5 ; B6", "A1 ; B5 ; A3",
        "A2 ; B1 ; B6", "B2 ; A3 ; B4", "B3 ; B6 ; A1", "A3 ; A1 ; B2",
        "B5 ; B4 ; A2")


def wide_pack(name, window, device=None, impl=None):
    from repro_torch.vector import MultiQueryEngine
    from repro_torch.vector.multiquery import build_packing
    if name == "nine":
        queries = [f"SELECT * FROM S WHERE {q} WITHIN {window} events"
                   for q in NINE]
        return MultiQueryEngine(queries, device=device, impl=impl)
    queries = [f"SELECT * FROM S WHERE A1 ; A2+ ; A3 WITHIN {window} events",
               f"SELECT * FROM S WHERE A2 ; A1 WITHIN {window} events"]
    return MultiQueryEngine.from_packing(
        build_packing(queries, pad_states=512, pad_queries=16),
        device=device, impl=impl)


def random_layout_operands(dev, S, Q, K, C, B, T, seed):
    """Builder operands over random predecessor tables of S states and Q
    queries (the arena of a padded pack keeps its live states only, so
    wide layouts are made here)."""
    rng = np.random.default_rng(seed)
    W, eps, cap = 6, 5, 1 << 12
    pidx = rng.integers(0, S, (C, S, K))
    pmark = rng.random((C, S, K)) < 0.5
    pvalid = rng.random((C, S, K)) < 0.3
    pvalid[:, 0] = False
    finals = rng.random((S, Q)) < 0.2
    lay = kref.arena_block_layout(W, S, K, Q, eps, cap, (1, 2), finals,
                                  pmark, pvalid)
    cid = rng.integers(0, cap, (B, W, S)).astype(np.int32)
    cid[rng.random((B, W, S)) < 0.7] = -1
    cells0 = tuple(torch.from_numpy(x).to(dev) for x in (
        cid, rng.integers(0, 2, (B, W, S)).astype(np.int32),
        rng.integers(-1, cap, (B, W, S)).astype(np.int32),
        rng.integers(-1, cap, (B, W, S)).astype(np.int32)))
    valid = rng.integers(0, T + 1, B)
    live = np.arange(T)[:, None] < valid[None, :]
    hits = (rng.random((T, B, Q)) < 0.3) & live[:, :, None]
    args = (cells0, torch.from_numpy(rng.integers(0, C, (T, B)).astype(
                np.int32)).to(dev), torch.from_numpy(hits).to(dev),
            torch.from_numpy(rng.integers(0, 10 ** 6, B)).to(dev),
            torch.from_numpy(valid).to(dev))
    kw = dict(lay=lay, ptab=torch.from_numpy(kref.pack_pred_tables(
                  pidx, pmark, pvalid)).to(dev),
              finals_sq=torch.from_numpy(finals.astype(np.int32)).to(dev))
    return args, kw, lay


@pytest.mark.parametrize("pack", ["nine", "S100Q10", "S512Q3"])
@pytest.mark.parametrize("consume,n_seg", [(False, 1), (True, 2)])
def test_wide_pack_arena_kernel_matches_plain_version(dev, pack, consume,
                                                      n_seg):
    """Packs past 32 states or 8 queries through the builder: the chain
    loop takes query q on warp q % 8."""
    B, T = 5, 32
    if pack == "nine":
        args, kw, lay = arena_operands(dev, wide_pack(pack, 9, device=dev),
                                       None, consume, B, T, seed=n_seg)
        assert (lay.S, lay.Q) == (63, 9)
    else:
        S, Q = (100, 10) if pack == "S100Q10" else (512, 3)
        args, kw, lay = random_layout_operands(dev, S, Q, 3, 4, B, T,
                                               seed=S + n_seg)
        if consume:
            kw["consume"] = torch.from_numpy(
                np.random.default_rng(S).random((T, B, S)) < 0.05).to(dev)
    launches = arena_update.DENSE.launches
    got = ops.arena_block_update(*args, n_seg=n_seg, impl="fused", **kw)
    torch.cuda.synchronize()
    assert arena_update.DENSE.launches == launches + 1
    want = ops.arena_block_update(*args, n_seg=n_seg, impl="ref", **kw)
    for g, w in zip(got[0] + got[1:], want[0] + want[1:]):
        assert torch.equal(g, w)
    assert int((got[4] >= 0).sum()) > 0


@pytest.mark.parametrize("pack", ["nine", "pad512"])
def test_wide_pack_engines_on_card(dev, pack):
    """A packed engine past 32 states and 8 queries on the card, fused and
    unfused and with the arena, equals the plain route and the CPU run."""
    B, T = 6, 32
    types = ["A1", "A2", "A3"] + [f"B{i}" for i in range(1, 7)]
    streams = [random_stream(StreamSpec(types, seed=b), 3 * T)
               for b in range(B)]
    runs, states = {}, {}
    for name, device, impl, cap in (("fused", None, "fused", None),
                                    ("unfused", None, "unfused", None),
                                    ("arena", None, "fused", 1 << 12),
                                    ("plain", None, "ref", None),
                                    ("cpu", "cpu", "fused", None)):
        se = StreamingVectorEngine(wide_pack(pack, 40, device, impl), T, B,
                                   arena_capacity=cap)
        runs[name] = [se.feed([s[i * T:(i + 1) * T] for s in streams])
                      for i in range(3)]
        states[name] = (se.state["C"] if cap else se.state).cpu()
    assert sum(int(c.sum()) for c, _ in runs["cpu"]) > 0
    for name in ("fused", "unfused", "arena", "plain"):
        for (ck, hk), (cp, hp) in zip(runs[name], runs["cpu"]):
            np.testing.assert_array_equal(ck, cp)
            assert hk == hp
        assert torch.equal(states[name], states["cpu"])


def test_arena_streaming_engine_on_card(dev):
    """Chunks through both kernels equal the plain route and the CPU run,
    node store included; the library is loaded once; enumerations equal
    the CPU engine's."""
    query = "SELECT * FROM S WHERE A1 ; A2+ ; A3 WITHIN 30 events"
    B, T = 8, 32
    streams = [random_stream(StreamSpec(["A1", "A2", "A3", "B1"], seed=b),
                             3 * T) for b in range(B)]
    runs, states, sets = {}, {}, {}
    for name, device, impl in (("kernel", None, None),
                               ("plain", None, "ref"),
                               ("cpu", "cpu", None)):
        se = StreamingVectorEngine(VectorEngine(query, device=device,
                                                impl=impl), T, B,
                                   arena_capacity=1 << 12)
        runs[name] = [se.feed([s[i * T:(i + 1) * T] for s in streams])
                      for i in range(3)]
        states[name] = se.snapshot()["arrays"]
        hits = [h for _, hs in runs[name] for h in hs]
        sets[name] = {k: [(c.start, c.end, c.data) for c in v]
                      for k, v in se.enumerate_hits(hits).items()}
        if name == "kernel":
            assert se.compile_count == 1
    for name in ("plain", "cpu"):
        for (ck, hk), (cp, hp) in zip(runs["kernel"], runs[name]):
            np.testing.assert_array_equal(ck, cp)
            assert hk == hp
        assert states["kernel"].keys() == states[name].keys()
        for k in states["kernel"]:
            np.testing.assert_array_equal(states["kernel"][k],
                                          states[name][k], err_msg=k)
        assert sets["kernel"] == sets[name]


# the store route: (query or pack, max_window_events, capacity, extras).
# The same queries as the dense sweep, CONSUME, ragged lanes, a capacity
# that overflows mid-chunk, the nine-query pack and K5 (32 states, K=18).
STORE_SWEEPS = {
    "count": (ARENA_QUERIES[0][0], None, 1 << 14, {}),
    "time": (STOCK_Q1, 40, 1 << 14, {}),
    "k5": (ARENA_QUERIES[2][0], None, 1 << 14, dict(ragged=True)),
    "consume": (ARENA_QUERIES[0][0], None, 1 << 14, dict(consume=0.05)),
    "ragged": (ARENA_QUERIES[0][0], None, 1 << 14, dict(ragged=True)),
    "overflow": (ARENA_QUERIES[0][0], None, 4000, {}),
    "nine": ("nine", None, 1 << 14, dict(consume=0.05)),
}


def store_chunks(dev, name, B, T, n_chunks):
    """Engine tables, an empty arena pair and random chunk operands of a
    store sweep: classes, hits on live steps only, per-lane starts and
    valid counts (ragged: some lanes short or dead), time-eviction masks
    for time windows and CONSUME masks."""
    query, mwe, cap, extra = STORE_SWEEPS[name]
    ve = (wide_pack("nine", 9, device=dev) if query == "nine" else
          VectorEngine(query, max_window_events=mwe, device=dev))
    at = ve.arena_tables()
    W, S, Q = ve.ring, at.num_states, at.num_queries
    rng = np.random.default_rng(len(name))
    chunks = []
    for i in range(n_chunks):
        start = np.full(B, (i * T) % W)
        valid = np.full(B, T)
        if extra.get("ragged"):
            start = (start + rng.integers(0, W, B)) % W
            valid = rng.integers(0, T + 1, B)
            valid[-1] = 0
        live = np.arange(T)[:, None] < valid[None, :]
        kw = {}
        if ve.window.is_time:
            kw["expire"] = torch.from_numpy(rng.random((T, B, W)) < 0.1
                                            ).to(dev)
        if "consume" in extra:
            kw["consume"] = torch.from_numpy(
                rng.random((T, B, S)) < extra["consume"]).to(dev)
        chunks.append((
            torch.from_numpy(rng.integers(0, at.pred_idx.shape[0], (T, B))
                             .astype(np.int32)).to(dev),
            (i * T + torch.arange(T, dtype=torch.int32, device=dev)
             )[:, None].expand(T, B),
            torch.from_numpy(start.astype(np.int32)).to(dev),
            torch.from_numpy(valid.astype(np.int32)).to(dev),
            torch.from_numpy((rng.random((T, B, Q)) < 0.3)
                             & live[:, :, None]).to(dev), kw))
    return ve, at, cap, chunks


@pytest.mark.parametrize("name", list(STORE_SWEEPS))
def test_store_kernel_matches_plain_version(dev, name):
    """The store kernel ≡ its plain version chunk after chunk: node store
    (sink slot included), cells, pointers, latches and roots; one store
    launch per chunk and no dense launch."""
    B, T, n_chunks = 9, 64, 3
    ve, at, cap, chunks = store_chunks(dev, name, B, T, n_chunks)
    arenas = {impl: tecs_arena.init_arena(B, cap, ve.ring, at.num_states,
                                          device=dev)
              for impl in ("fused", "ref")}
    latched = []
    for i, (cls, gpos, start, valid, hits, kw) in enumerate(chunks):
        launches = (arena_update.KERNEL.launches,
                    arena_update.DENSE.launches)
        roots = {}
        for impl, ar in arenas.items():
            _, roots[impl] = tecs_arena.arena_scan_block(
                at, ar, cls, gpos, start, valid, hits, epsilon=ve.epsilon,
                impl=impl, **kw)
        torch.cuda.synchronize()
        assert (arena_update.KERNEL.launches,
                arena_update.DENSE.launches) == (launches[0] + 1,
                                                 launches[1])
        for k, v in arenas["fused"].items():
            assert torch.equal(v, arenas["ref"][k]), f"{name}@{i}:{k}"
        assert torch.equal(roots["fused"], roots["ref"]), f"{name}@{i}"
        latched.append(int(arenas["fused"]["ovf"].sum()))
    assert int(arenas["fused"]["ptr"].sum()) > 0
    # the overflow sweep latches some lanes mid-chunk while others stay
    # under capacity; the others never reach it
    assert (0 < min(x for x in latched if x) < B if name == "overflow"
            else not any(latched))


def test_store_route_one_launch_per_chunk(dev):
    """Through StreamingVectorEngine(arena_capacity=…): exactly one store
    launch and one fused-scan launch per chunk, no dense launch; counts,
    store and roots ≡ the plain engine."""
    query = "SELECT * FROM S WHERE A1 ; A2+ ; A3 WITHIN 30 events"
    B, T = 8, 32
    streams = [random_stream(StreamSpec(["A1", "A2", "A3", "B1"], seed=b),
                             3 * T) for b in range(B)]
    kern = StreamingVectorEngine(VectorEngine(query, device=dev), T, B,
                                 arena_capacity=1 << 12)
    plain = StreamingVectorEngine(VectorEngine(query, device=dev,
                                               impl="ref"), T, B,
                                  arena_capacity=1 << 12)
    for i in range(3):
        before = (arena_update.KERNEL.launches, arena_update.DENSE.launches,
                  fused_scan.KERNEL.launches)
        ck, hk = kern.feed([s[i * T:(i + 1) * T] for s in streams])
        after = (arena_update.KERNEL.launches, arena_update.DENSE.launches,
                 fused_scan.KERNEL.launches)
        assert after == (before[0] + 1, before[1], before[2] + 1)
        cp, hp = plain.feed([s[i * T:(i + 1) * T] for s in streams])
        np.testing.assert_array_equal(ck, cp)
        assert hk == hp
    for k, v in kern.state["arena"].items():
        assert torch.equal(v, plain.state["arena"][k]), k
    assert kern._roots.keys() == plain._roots.keys()


def test_store_router_raises_past_shared_memory(dev):
    """A start table and allocation bitmap past the card's shared memory
    are refused before any launch (the dense route takes the same ring)."""
    B, T, S, W, cap = 2, 4, 2, 40_000, 64
    pm = np.zeros((1, S, 1), bool)
    pv = np.zeros((1, S, 1), bool)
    pv[0, 1, 0] = True
    finals = np.zeros((S, 1), bool)
    finals[1] = True
    lay = kref.arena_block_layout(W, S, 1, 1, 3, cap, (1,), finals, pm, pv)
    assert (arena_update.smem_bytes(lay) < arena_update.KERNEL.smem_limit()
            < arena_update.smem_bytes(lay, store=True))
    ar = tecs_arena.init_arena(B, cap, W, S, device=dev)
    cells0, sstart0 = tecs_arena.chunk_cells(ar)
    launches = arena_update.KERNEL.launches
    with pytest.raises(ValueError, match="shared memory"):
        ops.arena_store_update(
            ar, cells0, sstart0, torch.zeros((T, B), dtype=torch.int32,
                                             device=dev),
            torch.ones((T, B, 1), dtype=torch.int32, device=dev),
            torch.zeros((T, B), dtype=torch.int32, device=dev), 0, T,
            lay=lay, ptab=torch.from_numpy(kref.pack_pred_tables(
                np.ones((1, S, 1), np.int32), pm, pv)).to(dev),
            finals_sq=torch.from_numpy(finals.astype(np.int32)).to(dev))
    assert arena_update.KERNEL.launches == launches


def test_arena_router_raises_on_what_the_kernel_refuses(dev):
    """Past 512 states and int32 id overflow are refused; 40 states
    run."""
    B, T, S = 2, 4, 40
    pm = np.zeros((1, S, 1), bool)
    pv = np.zeros((1, S, 1), bool)
    pv[0, 2, 0] = True
    finals = np.zeros((S, 1), bool)
    finals[2] = True
    cells = tuple(torch.full((B, 8, S), -1, dtype=torch.int32, device=dev)
                  for _ in range(4))
    cls = torch.zeros((T, B), dtype=torch.int32, device=dev)
    hits = torch.ones((T, B, 1), dtype=torch.int32, device=dev)
    ptab = torch.zeros((1, S, 1, 3), dtype=torch.int32, device=dev)
    fin = torch.from_numpy(finals.astype(np.int32)).to(dev)
    lay = kref.arena_block_layout(8, S, 1, 1, 3, 64, (1,), finals, pm, pv)
    # 40 states equal the plain version
    got = ops.arena_block_update(cells, cls, hits, 0, T, lay=lay, ptab=ptab,
                                 finals_sq=fin, impl="fused")
    want = ops.arena_block_update(cells, cls, hits, 0, T, lay=lay,
                                  ptab=ptab, finals_sq=fin, impl="ref")
    for g, w in zip(got[0] + got[1:], want[0] + want[1:]):
        assert torch.equal(g, w)
    S = 513
    lay = kref.arena_block_layout(8, S, 1, 1, 3, 64, (1,),
                                  np.zeros((S, 1), bool),
                                  np.zeros((1, S, 1), bool),
                                  np.zeros((1, S, 1), bool))
    with pytest.raises(ValueError, match="det states"):
        ops.arena_block_update(
            tuple(torch.full((B, 8, S), -1, dtype=torch.int32, device=dev)
                  for _ in range(4)), cls, hits, 0, T, lay=lay,
            ptab=torch.zeros((1, S, 1, 3), dtype=torch.int32, device=dev),
            finals_sq=torch.zeros((S, 1), dtype=torch.int32, device=dev))
    S = 4
    lay = kref.arena_block_layout(8, S, 1, 1, 3, 2 ** 31 - 10, (1,),
                                  finals[:S], pm[:, :S], pv[:, :S])
    with pytest.raises(ValueError, match="overflow int32"):
        ops.arena_block_update(tuple(c[:, :, :S].contiguous()
                                     for c in cells), cls, hits, 0, T,
                               lay=lay, ptab=ptab[:, :S].contiguous(),
                               finals_sq=fin[:S])


# ---------------------------------------------------------------------------
# the unfused pipeline: bit-vector and scan kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,A,k", [(1, 1, 1), (7, 3, 6), (300, 8, 14),
                                   (5000, 5, 31)])
def test_bitvector_kernel_matches_plain_version(dev, N, A, k):
    rng = np.random.default_rng(N + A + k)
    attrs = rng.normal(size=(N, A)).astype(np.float32)
    attrs[rng.random((N, A)) < 0.1] = np.nan
    attrs[rng.random((N, A)) < 0.1] = 0.0
    specs = [(int(rng.integers(0, A)), i % 6,
              float(rng.choice([0.0, rng.normal()]))) for i in range(k)]
    x = torch.from_numpy(attrs)
    launches = bitvector.KERNEL.launches
    got = ops.bitvector(x.to(dev), specs)
    torch.cuda.synchronize()
    assert bitvector.KERNEL.launches == launches + 1
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), ops.bitvector(x, specs))


def scan_tables(rng, S, C, NQ, branching=True):
    """Tables with two successors per row, and entries of 2 where they
    coincide (the reference package's kernel tests).  Counts can then
    double every step, so wide windows take ``branching=False`` (at most
    one 1 per row) to stay below 2^24."""
    M = np.zeros((C, S, S), np.float32)
    for s in range(1, S):
        for c in range(C):
            for _ in range(2 if branching else 1):
                t = rng.integers(0, S)
                if t:
                    M[c, s, t] += 1
    finals = (rng.random((NQ, S)) < 0.4).astype(np.float32)
    finals[:, 0] = 0.0
    init = np.zeros(S, np.float32)
    init[rng.choice(np.arange(1, S), size=min(NQ, S - 1), replace=False)] = 1
    return M, finals, init


# (S, NQ, eps, W): the 8/16/32 buckets and the wide build; rings of
# exactly ε+1, padded, and one too large for one block's shared memory
# (W·S·4 > 227 KB, split over two blocks); query groups past 8
SCAN_CASES = [(5, 1, 6, 7), (12, 3, 9, 16), (28, 4, 40, 41),
              (20, 8, 3000, 3001), (40, 9, 6, 7), (100, 12, 30, 31),
              (24, 19, 8, 9)]


@pytest.mark.parametrize("S,NQ,eps,W", SCAN_CASES)
@pytest.mark.parametrize("start", [0, 123457])
def test_scan_kernels_match_plain_version(dev, S, NQ, eps, W, start):
    rng = np.random.default_rng(S * 7 + NQ + start)
    B, T, C = 9, 40, 6
    M, finals, init = scan_tables(rng, S, C, NQ, branching=eps < 10)
    ids = rng.integers(0, C, (T, B)).astype(np.int32)
    c0 = (rng.random((B, W, S)) < 0.02).astype(np.float32)
    c0[:, :, 0] = 0.0
    cuda = [torch.from_numpy(x).to(dev) for x in (ids, M, finals, init, c0)]
    cpu = [torch.from_numpy(x) for x in (ids, M, finals, init, c0)]
    n_multi, n_single = cea_scan.MULTI.launches, cea_scan.SINGLE.launches
    got = ops.cea_scan_multi(*cuda[:3], cuda[4], init_mask=cuda[3],
                             epsilon=eps, start_pos=start)
    got1 = ops.cea_scan(cuda[0], cuda[1], cuda[2][0], cuda[4], epsilon=eps,
                        start_pos=start)
    torch.cuda.synchronize()
    assert cea_scan.MULTI.launches == n_multi + 1
    assert cea_scan.SINGLE.launches == n_single + 1
    want = ops.cea_scan_multi(*cpu[:3], cpu[4], init_mask=cpu[3],
                              epsilon=eps, start_pos=start)
    want1 = ops.cea_scan(cpu[0], cpu[1], cpu[2][0], cpu[4], epsilon=eps,
                         start_pos=start)
    for g, w in zip(got + got1, want + want1):
        assert torch.equal(g.cpu(), w)
    assert float(got[0].max()) < 2 ** 24
    # the input ring is left untouched without inplace
    assert torch.equal(cuda[4].cpu(), cpu[4])


# (S, NQ, eps, W, split): rings of exactly ε+1 and padded, a split that
# plan_ring trims (W=7, split 5 → 4 blocks), the four state builds, query
# groups past 8
SCAN_SPLIT_CASES = [(5, 1, 6, 7, 2), (5, 2, 6, 7, 5), (12, 3, 9, 23, 3),
                    (28, 4, 7, 8, 3), (20, 9, 30, 31, 4),
                    (40, 10, 12, 13, 3), (70, 2, 6, 29, 5)]


@pytest.mark.parametrize("S,NQ,eps,W,split", SCAN_SPLIT_CASES)
def test_forced_scan_split_matches_plain_version(dev, S, NQ, eps, W, split):
    """Both scan entries with a lane's ring split over blocks: matches and
    ring equal the plain version exactly, with start 0, the seed and expiry
    slots on the first and last slot of every segment, and a chunked
    carry."""
    from repro_torch.kernels.fused_scan import plan_ring, segments
    rng = np.random.default_rng(S * 11 + NQ + split)
    B, T, C = 7, 48, 6
    M, finals, init = scan_tables(rng, S, C, NQ, branching=eps < 10)
    _, n = plan_ring(W, S, False, 10 ** 6, latest=False, consume=False,
                     split=split)
    assert n == -(-W // -(-W // split))
    starts = [0]
    for a, b in segments(W, n):
        starts += [a, b - 1, a + eps + 1, b - 1 + W * 7919]
    ids = torch.from_numpy(rng.integers(0, C, (T, B)).astype(
        np.int32)).to(dev)
    c0 = (rng.random((B, W, S)) < 0.05).astype(np.float32)
    c0[:, :, 0] = 0.0
    Mt, ft, it, c0 = (torch.from_numpy(x).to(dev)
                      for x in (M, finals, init, c0))
    for start in starts:
        for name, kern in (("multi", cea_scan.MULTI),
                           ("single", cea_scan.SINGLE)):
            def run(i, c, s, split_=split, impl="kernel"):
                cc = c.cpu() if impl == "plain" else c
                ii = i.cpu() if impl == "plain" else i
                mm, ff = ((Mt.cpu(), ft.cpu()) if impl == "plain"
                          else (Mt, ft))
                if name == "multi":
                    return ops.cea_scan_multi(
                        ii, mm, ff, cc, init_mask=it.to(cc.device),
                        epsilon=eps, start_pos=s, split=split_)
                return ops.cea_scan(ii, mm, ff[0], cc, epsilon=eps,
                                    start_pos=s, split=split_)
            launches = kern.launches
            got = run(ids, c0, start)
            torch.cuda.synchronize()
            assert kern.launches == launches + 1
            assert kern.last_plan == (True, n)
            want = run(ids, c0, start, impl="plain")
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)
            m1, c1 = run(ids[:20], c0, start)
            m2, c2 = run(ids[20:], c1, start + 20)
            assert torch.equal(torch.cat([m1, m2]), got[0])
            assert torch.equal(c2, got[1])
            assert float(got[0].max()) < 2 ** 24


def test_scan_default_split_matches_plain_version(dev):
    """A ring too large for one block's shared memory splits by default
    (plan_ring's smallest n_split whose share fits)."""
    rng = np.random.default_rng(3)
    S, NQ, eps, W, B, T, C = 28, 3, 3000, 3001, 5, 24, 6
    M, finals, init = scan_tables(rng, S, C, NQ, branching=False)
    ids = rng.integers(0, C, (T, B)).astype(np.int32)
    c0 = (rng.random((B, W, S)) < 0.01).astype(np.float32)
    cuda = [torch.from_numpy(x).to(dev) for x in (ids, M, finals, init, c0)]
    got = ops.cea_scan_multi(*cuda[:3], cuda[4], init_mask=cuda[3],
                             epsilon=eps, start_pos=77)
    torch.cuda.synchronize()
    use_smem, n = cea_scan.MULTI.last_plan
    assert use_smem and n >= 2
    want = ops.cea_scan_multi(*[x.cpu() for x in cuda[:3]], cuda[4].cpu(),
                              init_mask=cuda[3].cpu(), epsilon=eps,
                              start_pos=77)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_unfused_pipeline_and_engines_on_card(dev):
    """The unfused streaming engine and a packed engine on the card equal
    the fused kernel and the CPU run; the library is loaded once."""
    from repro_torch.vector import MultiQueryEngine
    query = "SELECT * FROM S WHERE A1 ; A2+ ; A3 WITHIN 50 events"
    packed = ["SELECT * FROM S WHERE A1 ; A2+ ; A3 WITHIN 50 events",
              "SELECT * FROM S WHERE A2 ; A3 WITHIN 50 events",
              "SELECT * FROM S WHERE A3 ; A1 ; A3 WITHIN 50 events"]
    B, T = 8, 32
    streams = [random_stream(StreamSpec(["A1", "A2", "A3"], seed=b), 4 * T)
               for b in range(B)]
    for make in (lambda device, impl: VectorEngine(query, device=device,
                                                   impl=impl),
                 lambda device, impl: MultiQueryEngine(packed, device=device,
                                                       impl=impl)):
        runs, states = {}, {}
        for name, device, impl in (("unfused", None, "unfused"),
                                   ("fused", None, "fused"),
                                   ("cpu", "cpu", "unfused")):
            se = StreamingVectorEngine(make(device, impl), T, B)
            runs[name] = [se.feed([s[i * T:(i + 1) * T] for s in streams])
                          for i in range(4)]
            states[name] = se.state.cpu()
            if device is None:
                assert se.compile_count == 1
        for name in ("fused", "cpu"):
            for (ck, hk), (cp, hp) in zip(runs["unfused"], runs[name]):
                np.testing.assert_array_equal(ck, cp)
                assert hk == hp
            assert torch.equal(states["unfused"], states[name])


def test_unfused_routers_raise_on_what_the_kernels_refuse(dev):
    """The scan routers refuse what the reference also refuses (past 512
    states, no query, a short ring, per-lane offsets, a split past the
    ring); scans past 32 states and 8 queries, and the unfused calls the
    scan kernels do not take, equal the plain version."""
    rng = np.random.default_rng(1)
    T, B = 4, 2
    ids = torch.zeros((T, B), dtype=torch.int32, device=dev)

    def scan(S, NQ, W, eps, **kw):
        M, finals, init = scan_tables(rng, S, 2, NQ)
        return ops.cea_scan_multi(
            ids, torch.from_numpy(M).to(dev),
            torch.from_numpy(finals).to(dev),
            torch.zeros((B, W, S), device=dev),
            init_mask=torch.from_numpy(init).to(dev), epsilon=eps, **kw)
    with pytest.raises(ValueError, match="det states"):
        scan(513, 1, 8, 3)
    with pytest.raises(ValueError, match="queries"):
        scan(12, 0, 8, 3)
    with pytest.raises(ValueError, match="1..8"):
        scan(12, 2, 8, 3, split=9)
    with pytest.raises(ValueError, match="ring"):
        scan(12, 2, 3, 3)
    with pytest.raises(ValueError, match="scalar start_pos"):
        scan(12, 2, 8, 3, start_pos=torch.zeros(B, device=dev))
    with pytest.raises(ValueError, match="at most 31"):
        ops.bitvector(torch.zeros((3, 1), device=dev),
                      [(0, 0, 0.0)] * 32)
    # 33 states and 9 queries: both scan entries equal the plain version
    for S, NQ in ((33, 1), (12, 9)):
        M, finals, init = scan_tables(rng, S, 2, NQ)
        ids_r = torch.from_numpy(rng.integers(0, 2, (T, B)).astype(
            np.int32))
        c0 = torch.from_numpy((rng.random((B, 8, S)) < 0.3).astype(
            np.float32))
        got = ops.cea_scan_multi(
            ids_r.to(dev), torch.from_numpy(M).to(dev),
            torch.from_numpy(finals).to(dev), c0.to(dev),
            init_mask=torch.from_numpy(init).to(dev), epsilon=3)
        want = ops.cea_scan_multi(
            ids_r, torch.from_numpy(M), torch.from_numpy(finals), c0,
            init_mask=torch.from_numpy(init), epsilon=3)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    # unfused cer_pipeline calls the scan kernels do not take go to the
    # fused kernel, as the reference package sends them to its fused
    # computation: one fused launch, nothing else, ≡ impl="fused"
    S, C, A, k = 6, 3, 2, 2
    specs, class_of, M, finals, init = random_tables(rng, S, C, A, k, 2)
    args = (torch.from_numpy(rng.normal(size=(T, B, A)).astype(
                np.float32)).to(dev), specs,
            torch.from_numpy(class_of).to(dev), None,
            torch.from_numpy(M).to(dev), torch.from_numpy(finals).to(dev))
    c0 = torch.from_numpy((rng.random((B, 8, S)) < 0.3).astype(
        np.float32)).to(dev)
    init_t = torch.from_numpy(init).to(dev)
    window = wkern.DeviceWindow.time(5.0, max_window_events=8)
    calls = [
        dict(epsilon=5, start_pos=torch.tensor([3, 0], dtype=torch.int32,
                                               device=dev)),
        dict(epsilon=5, valid_counts=torch.tensor([T, 1], device=dev)),
        dict(epsilon=5, latest_q=torch.ones(2, device=dev)),
        dict(epsilon=5, consume_sq=torch.ones((2, S), device=dev)),
        dict(window=window, event_ts=torch.arange(
            T * B, dtype=torch.float32, device=dev).reshape(T, B))]
    for kw in calls:
        state = (wkern.init_state(window, B, S, dev) if "window" in kw
                 else c0)
        n_fused = fused_scan.KERNEL.launches
        n_other = bitvector.KERNEL.launches + cea_scan.MULTI.launches
        got = ops.cer_pipeline(*args, state, init_mask=init_t,
                               impl="unfused", **kw)
        torch.cuda.synchronize()
        assert fused_scan.KERNEL.launches == n_fused + 1
        assert bitvector.KERNEL.launches + cea_scan.MULTI.launches == \
            n_other
        fused = ops.cer_pipeline(*args, state, init_mask=init_t,
                                 impl="fused", **kw)
        plain = ops.cer_pipeline(*args, state, init_mask=init_t, impl="ref",
                                 **kw)
        for g, f, p in zip(got, fused, plain):
            assert equal(g, f) and equal(g, p)


# ---------------------------------------------------------------------------
# PARTITION BY: the lane router and the partitioned engine
# ---------------------------------------------------------------------------


def zipf_keys(rng, pool, T, null_share=0.02):
    """(T,) uint32 key draws, Zipf-skewed over ``pool``, with NULL and raw
    EMPTY_LANE keys mixed in."""
    from repro_torch.core.partition import EMPTY_LANE, NULL_KEY_HASH
    w = 1.0 / np.arange(1, len(pool) + 1)
    keys = pool[rng.choice(len(pool), T, p=w / w.sum())].astype(np.uint32)
    r = rng.random(T)
    keys[r < null_share] = NULL_KEY_HASH
    keys[r > 1 - null_share / 4] = EMPTY_LANE
    return keys


def route_equal(got, want):
    return all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.parametrize("L", [1, 7, 64, 1024, 1500, 20000])
@pytest.mark.parametrize("evict", ["lru", "none"])
def test_lane_route_kernel_matches_plain(dev, L, evict):
    """Chained chunks from an empty table, then from a full table of other
    keys: allocations, LRU evictions and both spills, at lane counts that
    keep the router's counters and flags in shared memory and past it."""
    from repro_torch.core.partition import EMPTY_LANE
    rng = np.random.default_rng(L)
    T = 3000 if L < 20000 else 2500
    pool = rng.choice(EMPTY_LANE - 1, size=L + max(3, L // 2),
                      replace=False).astype(np.uint32)
    for prefill in (False, True):
        if prefill:      # every lane owned, lane_last with ties
            table = torch.from_numpy(rng.choice(EMPTY_LANE - 1, L).astype(
                np.uint32))
            last = torch.from_numpy(rng.integers(0, 3, L).astype(np.int32))
        else:
            table = torch.full((L,), EMPTY_LANE, dtype=torch.int64)
            last = torch.full((L,), -1, dtype=torch.int32)
        evicted = spilled = over_cap = 0
        for c in range(3 if L < 20000 else 2):
            keys = torch.from_numpy(zipf_keys(rng, pool, T))
            n0 = lane_route.KERNEL.launches
            got = ops.lane_route(keys.to(dev), table.to(dev), last.to(dev),
                                 chunk_idx=c + 3, cap=4, evict=evict)
            torch.cuda.synchronize()
            assert lane_route.KERNEL.launches == n0 + 1
            want = ops.lane_route(keys, table, last, chunk_idx=c + 3, cap=4,
                                  evict=evict)
            assert route_equal(got, want), (L, evict, prefill, c)
            evicted += int(want.evicted.sum())
            spilled += int(((want.lane == L) & ~want.null).sum())
            over_cap += int((want.rank >= 4).sum())
            table, last = want.lane_keys, want.lane_last
        if prefill:      # the table holds none of the chunk's keys
            assert (evicted > 0) == (evict == "lru")
            assert spilled > 0 or evict == "lru"
        if not prefill or evict == "lru":
            assert over_cap > 0


@pytest.mark.parametrize("L", [1, 3, 5])
@pytest.mark.parametrize("evict", ["lru", "none"])
def test_lane_route_kernel_matches_plain_on_hand_set_tables(dev, L, evict):
    """The CPU tests' hand-set tables: ties in lane_last, full tables, an
    all-NULL chunk, raw EMPTY_LANE keys, keys held in several lanes."""
    rng = random.Random(L * 7)
    for keys, table, last, chunk_idx in route_cases(rng, L):
        args = (torch.tensor(keys, dtype=torch.int64),
                torch.tensor(table, dtype=torch.int64),
                torch.tensor(last, dtype=torch.int32))
        for cap in (3, ROUTE_T):
            got = ops.lane_route(*(a.to(dev) for a in args),
                                 chunk_idx=chunk_idx, cap=cap, evict=evict)
            want = ops.lane_route(*args, chunk_idx=chunk_idx, cap=cap,
                                  evict=evict)
            assert route_equal(got, want), (keys, table, last, cap)


@pytest.mark.parametrize("L", [3, 7, 64, 1024, 1500])
@pytest.mark.parametrize("T", [24, 3000])
@pytest.mark.parametrize("evict", ["lru", "none"])
def test_lane_route_kernel_matches_plain_on_duplicate_tables(dev, L, T,
                                                             evict):
    """Tables that hold a key in several lanes: when LRU evicts the lowest
    of them, the walk sends the key's events to the next lane that still
    holds it."""
    rng = np.random.default_rng(L * 31 + T)
    moved = 0
    for keys, table, last, chunk_idx in dup_tables(rng, L, T):
        args = tuple(map(torch.from_numpy, (keys, table, last)))
        n0 = lane_route.KERNEL.launches
        got = ops.lane_route(*(a.to(dev) for a in args),
                             chunk_idx=chunk_idx, cap=4, evict=evict)
        torch.cuda.synchronize()
        assert lane_route.KERNEL.launches == n0 + 1
        want = ops.lane_route(*args, chunk_idx=chunk_idx, cap=4,
                              evict=evict)
        assert route_equal(got, want), (L, T, evict, chunk_idx)
        moved += later_holders(keys, table, want.lane)
    if evict == "none":
        assert moved == 0
    elif T > ROUTE_T:
        assert moved > 0


def churn_engine(dev, evict, impl=None):
    from repro_torch.vector import PartitionedStreamingEngine
    ve = VectorEngine("SELECT * FROM S WHERE A1 ; A2 ; A3 WITHIN 400 events",
                      device=dev, impl=impl)
    return PartitionedStreamingEngine(ve, ("uid",), 1024, 16, lane_cap=48,
                                      evict=evict, arena_capacity=1 << 14)


def churn_chunks(ve_encoder, rng, n_chunks, T=1024, n_keys=24):
    codes = np.array([ve_encoder.vocab["type"].get(t, -1.0)
                      for t in ("A1", "A2", "A3", "B1")], np.float32)
    pool = np.arange(1000, 1000 + n_keys, dtype=np.uint32)
    return [(torch.from_numpy(codes[rng.integers(0, 4, (T, 1))]),
             zipf_keys(rng, pool, T)) for _ in range(n_chunks)]


@pytest.mark.parametrize("evict", ["lru", "none"])
def test_partitioned_kernels_match_plain_on_churn(dev, evict):
    """Evictions, both spills and the arena: the engine with its kernels
    (one router, one fused and one store launch per feed) ≡ impl="ref"
    (counts, hits, stats, every snapshot leaf, enumerated sets)."""
    kern, plain = churn_engine(None, evict), churn_engine(None, evict, "ref")
    chunks = churn_chunks(kern.encoder, np.random.default_rng(5), 4)
    hits = []
    for attrs, keys in chunks:
        counters = [k.launches for k in (lane_route.KERNEL,
                                         fused_scan.KERNEL,
                                         arena_update.KERNEL)]
        ck, hk = kern.feed_keyed(attrs.to(dev), keys)
        torch.cuda.synchronize()
        assert [k.launches for k in (lane_route.KERNEL, fused_scan.KERNEL,
                                     arena_update.KERNEL)] == \
            [n + 1 for n in counters]
        cp, hp = plain.feed_keyed(attrs.to(dev), keys)
        np.testing.assert_array_equal(ck, cp)
        assert hk == hp
        hits += hk
    assert kern.stats == plain.stats
    st = kern.stats
    assert st.spilled_capacity > 0 and st.spilled_table > 0
    assert (st.evicted_lanes > 0) == (evict == "lru")
    assert kern.compile_count == 1
    sk, sp = kern.snapshot(), plain.snapshot()
    assert sk["meta"] == sp["meta"]
    for k in sp["arrays"]:
        np.testing.assert_array_equal(sk["arrays"][k], sp["arrays"][k],
                                      err_msg=k)
    assert hits
    got, want = kern.enumerate_hits(hits), plain.enumerate_hits(hits)
    assert {p: sorted((c.start, c.end, c.data) for c in v)
            for p, v in got.items()} == \
        {p: sorted((c.start, c.end, c.data) for c in v)
         for p, v in want.items()}


# ---------------------------------------------------------------------------
# recovery and the service on the card: replay determinism
# ---------------------------------------------------------------------------

def assert_same_snapshot(a, b):
    assert a["meta"] == b["meta"]
    assert a["arrays"].keys() == b["arrays"].keys()
    for k, v in a["arrays"].items():
        w = b["arrays"][k]
        assert v.dtype == w.dtype and v.shape == w.shape, k
        assert v.tobytes() == w.tobytes(), k


def test_partitioned_replay_is_bit_identical_on_card(dev):
    """Snapshot, feed a chunk, restore, feed it again: the router's ballots
    and walk, the fused kernel and the store kernel's id ranks give the
    same counts, hits and every snapshot leaf byte for byte (the
    recovery runner's replay check relies on it)."""
    eng = churn_engine(None, "lru")
    chunks = churn_chunks(eng.encoder, np.random.default_rng(7), 4)
    for attrs, keys in chunks[:2]:
        eng.feed_keyed(attrs.to(dev), keys)
    snap0 = eng.snapshot()
    runs = []
    for _ in range(2):
        eng.restore(snap0)
        out = [eng.feed_keyed(a.to(dev), k) for a, k in chunks[2:]]
        runs.append((out, eng.snapshot()))
    (out1, snap1), (out2, snap2) = runs
    assert any(h for _, h in out1)
    for (c1, h1), (c2, h2) in zip(out1, out2):
        assert c1.tobytes() == c2.tobytes() and h1 == h2
    assert_same_snapshot(snap1, snap2)
    assert eng.stats.evicted_lanes > 0


def test_fused_split_feed_is_bit_identical_on_replay(dev):
    """A forced split over two blocks per lane adds partial counts with
    atomicAdd, in any order: exact for f32 integers below 2^24, so two
    feeds from the same state agree byte for byte."""
    ve = VectorEngine("SELECT * FROM S WHERE A1 ; A2 ; A3 WITHIN 3200 "
                      "events", device=dev)
    B, T = 256, 256
    state0 = ve.init_state(B)
    types = ["A1", "A2", "A3", "B1", "B2", "B3"]
    t = ve.tables
    outs = []
    for attempt in range(2):
        state = state0.clone()
        counts = []
        for i in range(3):
            attrs = type_attrs_np(ve.encoder, np.random.default_rng(i), T, B,
                                  types).to(dev)
            m, _ = ops.cer_pipeline(
                attrs, ve.encoder.specs, t.class_of, t.class_ind, t.m_all,
                t.finals[None, :], state, init_mask=t.init_mask,
                window=ve.window, start_pos=(i * T) % ve.ring, split=2,
                inplace=True)
            counts.append(m.cpu().numpy())
        assert fused_scan.KERNEL.last_plan[1] == 2
        outs.append((np.stack(counts), state.cpu().numpy()))
    assert outs[0][0].max() > 0 and outs[0][0].max() < 2 ** 24
    assert outs[0][0].tobytes() == outs[1][0].tobytes()
    assert outs[0][1].tobytes() == outs[1][1].tobytes()


def type_attrs_np(encoder, rng, T, B, types):
    codes = np.array([encoder.vocab["type"].get(x, -1.0) for x in types],
                     np.float32)
    return torch.from_numpy(codes[rng.integers(0, len(types), (T, B))]
                            [:, :, None])


def keyed_event_chunks(n_chunks, T, seed):
    from repro_torch.core.events import Event
    rng = random.Random(seed)
    evs = [Event(rng.choice(["A1", "A2", "A3", "B1"]),
                 {} if rng.random() < 0.05
                 else {"uid": rng.choice(["u1", "u2", 7, None, "u3"])})
           for _ in range(n_chunks * T)]
    return [evs[lo:lo + T] for lo in range(0, len(evs), T)]


def test_runner_resumes_cuda_engine_onto_fresh_cuda_engine(dev, tmp_path):
    """A recovery directory written by a runner over a CUDA engine (router,
    fused and store kernels) resumes onto a fresh CUDA engine; the
    cumulative match set equals an uninterrupted CUDA run and a CPU run."""
    from repro_torch.runtime import RecoveringStreamRunner, cumulative_matches
    chunks = keyed_event_chunks(12, 1024, 11)

    def run(device, d, stop=None, resume=False):
        r = RecoveringStreamRunner(churn_engine(device, "lru"), str(d),
                                   every=4)
        if resume:
            assert r.resume() and r.chunk_index == 4 and r.replaying
        flags = [r.process(ch)[2] for ch in chunks[r.chunk_index:stop]]
        if stop is None:
            r.close()
        else:
            r.manager.wait()
        return flags

    assert all(run(None, tmp_path / "cuda"))
    assert all(run("cpu", tmp_path / "cpu"))
    run(None, tmp_path / "crashed", stop=7)
    assert run(None, tmp_path / "crashed", resume=True) == \
        [False] * 3 + [True] * 5
    want = cumulative_matches(str(tmp_path / "cpu"))
    assert want["hits"]
    assert cumulative_matches(str(tmp_path / "cuda")) == want
    assert cumulative_matches(str(tmp_path / "crashed")) == want


def test_service_on_cuda_engine_matches_cpu_engine(dev, tmp_path):
    """The same raws through a service over a CUDA partitioned engine and
    over a CPU one: receipts, alerts, counters, the emission log and the
    dead-letter file agree; one router and one fused launch per chunk."""
    from repro_torch.runtime import EventValidator, StreamService
    rng = np.random.default_rng(2)
    raws = [{"type": "ABC"[int(rng.integers(0, 3))], "t": float(i),
             "uid": int(rng.integers(0, 6))} for i in range(96 * 16)]
    raws[40:40] = [{"type": "Z", "t": 1.0}, "junk", {"t": 2.0}]
    out = {}
    for device in (None, "cpu"):
        ve = VectorEngine("SELECT * FROM S WHERE A ; B+ ; C WITHIN 30 [t]",
                          max_window_events=64, device=device)
        from repro_torch.vector import PartitionedStreamingEngine
        eng = PartitionedStreamingEngine(ve, ("uid",), chunk_len=128,
                                         num_lanes=8, strict_overflow=True)
        alerts = []
        d = tmp_path / str(device)
        counters = [k.launches for k in (lane_route.KERNEL,
                                         fused_scan.KERNEL)]
        svc = StreamService(eng, str(d), checkpoint_every=3,
                            sinks=[lambda c, h: alerts.append((c, h))],
                            validator=EventValidator(
                                allowed_types={"A", "B", "C"}))
        rc = [svc.submit(r, block=True, timeout=60.0) for r in raws]
        svc.drain(pad=True, timeout=120.0)
        svc.close()
        launches = [k.launches - n for k, n in zip(
            (lane_route.KERNEL, fused_scan.KERNEL), counters)]
        m = {k: v for k, v in vars(svc.metrics).items()
             if k not in ("chunk_latency_s", "queue_peak")}
        out[device] = (alerts, [(r.status, r.seq, r.reason) for r in rc], m,
                       (d / "matches.log").read_bytes(),
                       (d / "dead_letter.jsonl").read_bytes(), launches)
    gpu, cpu = out[None], out["cpu"]
    assert gpu[:5] == cpu[:5]
    assert gpu[2]["chunks"] == 12 and gpu[2]["rejected"] == 3
    assert gpu[5] == [12, 12] and cpu[5] == [0, 0]
    assert gpu[0]


# ---------------------------------------------------------------------------
# QueryFleet on the card ≡ the same fleet on the CPU
# ---------------------------------------------------------------------------

FLEET_W1 = ("SELECT * FROM S WHERE (E AS a; E AS b; E AS c; E AS d) FILTER "
            "a[x > 1] AND a[y < 8] AND b[x > 3] AND b[z < 6] AND c[u > 2] "
            "AND c[v < 7] AND d[x < 5] AND d[y > 4] WITHIN 8 events")
FLEET_W2 = ("SELECT * FROM S WHERE (E AS a; E AS b) FILTER a[z > 6] AND "
            "a[u < 3] AND b[v > 5] AND b[y > 2] AND a[x = 4] WITHIN 8 events")
FLEET_PAIR = ("SELECT * FROM S WHERE (E AS a; E AS b) FILTER a[x > 6] AND "
              "b[x < 3] WITHIN {}")
FIG8_TYPES = ["A1", "A2", "A3"] + [f"B{i}" for i in range(1, 7)]
FIG8_FLEET = ["SELECT * FROM S WHERE " + s + " WITHIN 40 events" for s in
              ("A1 ; A2 ; A3", "B1 ; B2 ; B3", "B4 ; B5 ; B6",
               "A1 ; B5 ; A3", "A2 ; B1 ; A3")]
# (fleet kwargs, event types, attributes, missing share, operations):
# ("add", text, qid) | ("remove", qid) | ("feed", chunk index)
FLEET_SCRIPTS = {
    "churn": ({}, ("E",), ("x", "y"), 0.0, [
        ("add", FLEET_PAIR.format("8 events"), "a"),
        ("add", FLEET_PAIR.format("4 events"), "c"), ("feed", 0),
        ("add", FLEET_PAIR.format("8 seconds"), "t"), ("feed", 1),
        ("add", FLEET_PAIR.replace("x", "y").format("8 events"), "b"),
        ("feed", 2), ("remove", "b"), ("feed", 3), ("remove", "c"),
        ("add", FLEET_PAIR.replace("x", "y").format("8 events"), "b2"),
        ("feed", 4)]),
    "churn_arena": (dict(arena_capacity=1 << 12), ("E",), ("x", "y"), 0.0, [
        ("add", FLEET_PAIR.format("8 events"), "a"),
        ("add", FLEET_PAIR.replace("x", "y").format("8 events"), "b"),
        ("feed", 0), ("feed", 1), ("remove", "b"), ("feed", 2),
        ("add", FLEET_PAIR.replace("x", "y").format("8 events"), "b2"),
        ("feed", 3)]),
    "bits16": ({}, ("E",), ("x", "y", "z", "u", "v"), 0.1, [
        ("add", FLEET_W1, "w1"), ("feed", 0), ("add", FLEET_W2, "w2"),
        ("feed", 1), ("feed", 2), ("remove", "w1"), ("feed", 3)]),
    "state_bucket_32_to_64": ({}, FIG8_TYPES, (), 0.0, [
        *[("add", q, f"f{i}") for i, q in enumerate(FIG8_FLEET[:4])],
        ("feed", 0), ("add", FIG8_FLEET[4], "f4"), ("feed", 1),
        ("feed", 2), ("remove", "f4"), ("feed", 3)]),
    "attr_slots": ({}, ("E", "F"), ("x", "y", "z", "u", "v"), 0.3, [
        ("add", FLEET_PAIR.replace("b[x", "b[v").format("8 events"), "p"),
        ("feed", 0),
        ("add", "SELECT * FROM S WHERE (E AS a; F AS b) FILTER a[u > 6] "
         "AND b[z < 3] AND b[y > 1] WITHIN 8 events", "q"),
        ("feed", 1), ("feed", 2)]),
}


def fleet_chunks(seed, n, T, B, types, attrs, missing):
    from repro_torch.core.events import Event
    rng = np.random.default_rng(seed)
    return [[[Event(str(types[int(rng.integers(0, len(types)))]),
                    {a: float(rng.integers(0, 10)) for a in attrs
                     if rng.random() >= missing},
                    timestamp=float(c * T + t))
              for t in range(T)] for _ in range(B)] for c in range(n)]


def run_fleet_script(device, name, T=32, B=4):
    """One fleet through a script; every observable after every op, the
    fused and store launches per feed, and the final snapshot."""
    import json
    from repro_torch.runtime import QueryFleet
    kw, types, attrs, missing, ops_ = FLEET_SCRIPTS[name]
    chunks = fleet_chunks(7, 5, T, B, types, attrs, missing)
    fleet = QueryFleet(chunk_len=T, batch=B, device=device, **kw)
    rec, launches = [], []
    for op in ops_:
        if op[0] == "add":
            fleet.add_query(op[1], qid=op[2])
        elif op[0] == "remove":
            fleet.remove_query(op[1])
        else:
            n0 = (fused_scan.KERNEL.launches, arena_update.KERNEL.launches)
            counts, hits = fleet.feed(chunks[op[1]])
            launches.append((fused_scan.KERNEL.launches - n0[0],
                             arena_update.KERNEL.launches - n0[1],
                             fleet.num_buckets))
            rec.append((counts, hits))
        rec.append((fleet.live_qids, fleet.compile_count,
                    fleet.distinct_geometries, fleet.cache_hits,
                    fleet.cost_report(), json.dumps(fleet.manifest())))
    return fleet, rec, launches, fleet.snapshot()["arrays"]


@pytest.mark.parametrize("name", list(FLEET_SCRIPTS))
def test_fleet_on_card_matches_cpu_fleet(dev, name):
    """Counts, hits, cache counters, cost reports, manifests and snapshot
    leaves of a fleet on the card equal the CPU fleet's after every op; one
    fused launch per bucket per feed (and one store launch with the
    arena); padded bits, attributes, states and query slots stay dead."""
    from repro_torch.kernels.build import LIBRARY
    gpu, rec_g, launches, snap_g = run_fleet_script(None, name)
    cpu, rec_c, _, snap_c = run_fleet_script("cpu", name)
    assert gpu.device.type == "cuda"
    assert len(rec_g) == len(rec_c)
    for a, b in zip(rec_g, rec_c):
        if isinstance(a[0], np.ndarray):
            assert np.array_equal(a[0], b[0]) and a[1] == b[1]
        else:
            assert a == b
    assert sorted(snap_g) == sorted(snap_c)
    for k in snap_g:
        assert np.array_equal(snap_g[k], snap_c[k]), k
    arena = "arena_capacity" in FLEET_SCRIPTS[name][0]
    assert all(f == n and s == (n if arena else 0)
               for f, s, n in launches), launches
    assert LIBRARY.loads == 1
    # the padded geometries the script went through (cost reports)
    geos = {r["geometry"] for a in rec_g if not isinstance(a[0], np.ndarray)
            for r in a[4].values()}
    if name == "bits16":
        assert any(g[3] == 16 for g in geos)          # 14 live bits
    if name == "state_bucket_32_to_64":
        assert {g[0] for g in geos} == {8, 16, 32, 64}
        assert gpu._find_bucket("f0").engine._entry.state_bucket == 32
    if name == "attr_slots":
        assert {g[4] for g in geos} == {4, 8}         # 2-3, then 6 columns
    assert any(a[0].any() for a in rec_g if isinstance(a[0], np.ndarray))


# ---------------------------------------------------------------------------
# distribution: an NCCL group of one rank (repro_torch.vector.distributed)
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_group(dev, tmp_path):
    from repro_torch.launch.mesh import make_production_mesh
    g = make_production_mesh(str(tmp_path / "store"))
    yield g
    g.close()


def test_nccl_world_one_group_routes_kept_rows(nccl_group):
    """make_production_mesh without torchrun's variables: NCCL, one rank on
    cuda:0.  The router's one all_to_all on the card gives the closed form
    of one rank (kept rows in order, then zero rows), NaN in a dropped row
    touching no kept row; block and gather are the identity."""
    from repro_torch.vector.distributed import route_by_partition
    g = nccl_group
    assert (g.rank, g.world_size, g.backend) == (0, 1, "nccl")
    assert g.device == torch.device("cuda", 0)
    ev = np.array([[1, 2], [np.nan, 5], [3, 4], [6, 7]], np.float32)
    drop = np.array([False, True, False, False])
    payload = np.arange(8, dtype=np.int32).reshape(4, 2)
    routed, pl, keep = route_by_partition(
        g, torch.from_numpy(ev).cuda(), torch.tensor([3, 1, 4, 1]).cuda(),
        payload=torch.from_numpy(payload).cuda(),
        drop=torch.from_numpy(drop).cuda())
    assert np.array_equal(routed.cpu().numpy(), np.concatenate(
        [ev[~drop], np.zeros((1, 2), np.float32)]))
    assert np.array_equal(pl.cpu().numpy(), np.concatenate(
        [payload[~drop], np.zeros((1, 2), np.int32)]))
    assert keep.cpu().numpy().tolist() == (~drop).tolist()
    x = torch.arange(12, device="cuda", dtype=torch.int32)
    assert torch.equal(g.gather(g.block(x)), x)


def test_sharded_pipeline_on_card_matches_unsharded(nccl_group):
    """sharded_cer_pipeline and sharded_cea_scan on an NCCL group of one
    rank ≡ the unsharded ops calls on the card ≡ the plain versions; one
    fused_scan and one cea_scan launch."""
    from repro_torch.vector.distributed import (sharded_cea_scan,
                                                sharded_cer_pipeline)
    g = nccl_group
    rng = np.random.default_rng(21)
    specs, class_of, M, finals, init = random_tables(rng, 9, 8, 3, 3, 2)
    T, B, eps = 64, 16, 40
    W = eps + 1
    attrs = rng.normal(size=(T, B, 3)).astype(np.float32)
    ind = ops.class_indicator(class_of, 8)
    c = lambda x: torch.from_numpy(np.asarray(x)).cuda()
    args = (c(attrs), specs, c(class_of), ind.cuda(), c(M), c(finals))
    kw = dict(init_mask=c(init), epsilon=eps, start_pos=5)
    n0 = fused_scan.KERNEL.launches
    m_s, r_s = sharded_cer_pipeline(g, *args, torch.zeros(
        (B, W, 9), device="cuda"), **kw)
    assert fused_scan.KERNEL.launches == n0 + 1
    m_u, r_u = ops.cer_pipeline(*args, torch.zeros((B, W, 9),
                                                   device="cuda"), **kw)
    cpu = [torch.from_numpy(np.asarray(x)) for x in
           (attrs, class_of, M, finals, init)]
    m_p, r_p = ops.cer_pipeline(cpu[0], specs, cpu[1], ind, cpu[2], cpu[3],
                                torch.zeros((B, W, 9)), init_mask=cpu[4],
                                epsilon=eps, start_pos=5)
    assert equal(m_s, m_u) and equal(r_s, r_u)
    assert equal(m_s.cpu(), m_p) and equal(r_s.cpu(), r_p)
    ids = rng.integers(0, 8, (T, B)).astype(np.int32)
    n0 = cea_scan.SINGLE.launches
    s_m, s_r = sharded_cea_scan(g, c(ids), c(M), c(finals[0]), r_u.clone(),
                                epsilon=eps, start_pos=T)
    assert cea_scan.SINGLE.launches == n0 + 1
    p_m, p_r = ops.cea_scan(torch.from_numpy(ids), cpu[2], cpu[3][0],
                            r_u.cpu(), epsilon=eps, start_pos=T)
    assert equal(s_m.cpu(), p_m) and equal(s_r.cpu(), p_r)


def test_routed_feed_on_card_matches_cpu_feed(nccl_group):
    """route_partitioned_chunk then feed_keyed(positions=) on the card ≡
    an unsharded CPU feed of the same chunks (counts at global positions,
    hits), with NULL keys and NULL attributes; one lane_route and one
    fused_scan launch a chunk."""
    from repro_torch.core.events import Event
    from repro_torch.vector import PartitionedStreamingEngine
    from repro_torch.vector.distributed import route_partitioned_chunk
    g = nccl_group
    query = ("SELECT * FROM S WHERE A AS a ; B AS b "
             "FILTER a[price > 5.0] WITHIN 8 events")
    rng = random.Random(6)
    stream = [Event(rng.choice("AB"), {} if rng.random() < 0.25 else
                    {"uid": rng.choice(["u1", "u2", "u3"]),
                     "price": float(rng.randint(0, 10))})
              for _ in range(64)]
    card = PartitionedStreamingEngine(VectorEngine(query), ("uid",),
                                      chunk_len=16, num_lanes=8)
    plain = PartitionedStreamingEngine(VectorEngine(query, device="cpu"),
                                       ("uid",), chunk_len=16, num_lanes=8)
    got, want, hits = np.zeros(64, np.int64), [], []
    n0 = (lane_route.KERNEL.launches, fused_scan.KERNEL.launches)
    for lo in range(0, 64, 16):
        attrs, keys = card.encoder.encode_stream_with_keys(
            stream[lo:lo + 16], ("uid",))
        c, _ = plain.feed_keyed(attrs, keys)
        want.append(c)
        a2, k2, p2, valid, _ = route_partitioned_chunk(
            g, torch.from_numpy(attrs).cuda(), keys,
            torch.arange(lo, lo + 16, dtype=torch.int32, device="cuda"))
        p2, v = p2.cpu().numpy(), valid.cpu().numpy()
        c, h = card.feed_keyed(a2, k2, positions=p2)
        got[p2[v]] = c[v]
        hits += h
    assert (lane_route.KERNEL.launches - n0[0],
            fused_scan.KERNEL.launches - n0[1]) == (4, 4)
    want = np.concatenate(want)
    assert np.array_equal(got, want) and want.sum() > 0
    assert sorted(hits) == np.nonzero(want)[0].tolist()
