"""The Hopper kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one; none imports
JAX.  Run them on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance 0: counts are f32 integers, exact below 2^24 in any order of
summation, and the arena builder's records, roots and cells are int32 node
ids, so kernel and plain version agree bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.data import StreamSpec, random_stream
from repro_torch.kernels import arena_update, bitvector, cea_scan, fused_scan
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import window as wkern
from repro_torch.vector import StreamingVectorEngine, VectorEngine
from repro_torch.vector import tecs_arena

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels are CUDA C++ "
                    "and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def random_tables(rng, S, C, A, k, NQ):
    """Random tables whose rows hold at most one 1, so run counts cannot
    grow past 2^24 however wide the window; branching tables are covered by
    the real queries of the streaming test and of chip_smoke.py."""
    specs = tuple((int(rng.integers(0, A)), int(rng.integers(0, 6)),
                   float(np.float32(rng.normal()))) for _ in range(k))
    class_of = rng.integers(0, C, 1 << k).astype(np.int32)
    M = np.zeros((C, S, S), np.float32)
    for s in range(1, S):
        for c in range(C):
            if rng.random() < 0.8:
                M[c, s, rng.integers(1, S)] = 1.0
    finals = (rng.random((NQ, S)) < 0.4).astype(np.float32)
    finals[:, 0] = 0.0
    init = np.zeros(S, np.float32)
    init[1] = 1.0
    return specs, class_of, M, finals, init


def equal(a, b):
    if isinstance(a, dict):
        return all(torch.equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


# (S, NQ, W-or-size, timed): the 8/16/32-state builds, a ring too large for
# shared memory (W·S·4 > 227 KB), time windows, several queries; the wide
# build (S > 32) and query groups past 8
CASES = [(5, 1, 7, False), (9, 2, 31, False), (26, 3, 100, False),
         (15, 1, 4000, False), (7, 2, 9.0, True), (13, 1, 40.0, True),
         (40, 9, 31, False), (70, 11, 9.0, True), (20, 17, 12, False)]


@pytest.mark.parametrize("S,NQ,win,timed", CASES)
@pytest.mark.parametrize("latest,consume", [(False, False), (True, True),
                                            (True, False), (False, True)])
def test_kernel_matches_plain_version(dev, S, NQ, win, timed, latest,
                                      consume):
    rng = np.random.default_rng(S * 31 + NQ)
    B, T, A, k, C = 37, 64, 3, 5, 6
    specs, class_of, M, finals, init = random_tables(rng, S, C, A, k, NQ)
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
    got = ops.cer_pipeline(*args, c0, impl="fused", **kw)
    torch.cuda.synchronize()
    assert fused_scan.KERNEL.launches == launches + 1
    # the 4000-slot ring does not fit one block: a sum-only call splits
    # it over two blocks, LAST or CONSUME reads it in global memory
    if S == 15:
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
               (33, 9, 29, None)]


@pytest.mark.parametrize("S,NQ,W,eps", SPLIT_CASES)
@pytest.mark.parametrize("split", [2, 3, 5])
def test_forced_split_matches_plain_version(dev, S, NQ, W, eps, split):
    """Each block keeps a share of the ring: counts, trace, ring, ts ring
    and ovf equal the plain version exactly, with the seed and expiry slots
    on the first and last slot of every segment."""
    rng = np.random.default_rng(S * 13 + NQ + split)
    T, A, k, C = 64, 3, 5, 6
    timed = eps is None
    specs, class_of, M, finals, init = random_tables(rng, S, C, A, k, NQ)
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
    got = ops.cer_pipeline(*args, c0, impl="fused", split=split, **kw)
    torch.cuda.synchronize()
    assert fused_scan.KERNEL.launches == launches + 1
    assert fused_scan.KERNEL.last_plan == (True, n) and n > 1
    want = ops.cer_pipeline(*args, c0, impl="ref", **kw)
    for g, w in zip(got, want):
        assert equal(g, w)
    if timed:
        assert bool(got[1]["ovf"][1])
    assert float(got[0][:, -2:].abs().max()) == 0.0   # dead lanes emit 0
    assert float(got[0].max()) > 0 and float(got[0].max()) < 2 ** 24


@pytest.mark.parametrize("split", [1, 2])
def test_forced_split_in_global_memory_matches_plain_version(dev, split):
    """A forced split whose share does not fit shared memory (480 KB a
    lane) reads its segment of the ring in global memory."""
    rng = np.random.default_rng(split)
    S, NQ, W, eps, B, T, A, k, C = 15, 2, 8000, 7990, 9, 32, 3, 5, 6
    specs, class_of, M, finals, init = random_tables(rng, S, C, A, k, NQ)
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
    got = ops.cer_pipeline(*args, impl="fused", split=split, **kw)
    torch.cuda.synchronize()
    assert fused_scan.KERNEL.last_plan == (False, split)
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
