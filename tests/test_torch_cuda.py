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
# shared memory (W·S·4 > 227 KB), time windows, several queries
CASES = [(5, 1, 7, False), (9, 2, 31, False), (26, 3, 100, False),
         (15, 1, 4000, False), (7, 2, 9.0, True), (13, 1, 40.0, True)]


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
    latest_q = None
    if latest:
        latest_q = torch.zeros(NQ, device=dev)
        latest_q[-1] = 1.0
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


# (S, NQ, W, eps): rings that no split of 2, 3 or 5 divides, NQ 1 and 8,
# the three state builds; eps None is a time window of rate bound W
SPLIT_CASES = [(5, 1, 31, 30), (9, 8, 23, 9), (26, 3, 17, 16),
               (7, 1, 37, None), (13, 8, 29, None)]


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
    B, T, S = 2, 4, 40
    rng = np.random.default_rng(0)
    specs, class_of, M, finals, init = random_tables(rng, S, 3, 2, 2, 1)
    with pytest.raises(ValueError, match="det states"):
        ops.cer_pipeline(
            torch.zeros((T, B, 2), device=dev), specs,
            torch.from_numpy(class_of).to(dev), None,
            torch.from_numpy(M).to(dev), torch.from_numpy(finals).to(dev),
            torch.zeros((B, 8, S), device=dev),
            init_mask=torch.from_numpy(init).to(dev), epsilon=3)
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
    """Random chunk operands for the builder of ``query``'s tables: a
    sparse chunk-start cell table, classes, hits only on live steps,
    a quarter of the lanes at start 0 and some lanes dead."""
    ve = VectorEngine(query, max_window_events=mwe, device=dev)
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
    launches = arena_update.KERNEL.launches
    got = ops.arena_block_update(*args, n_seg=n_seg, impl="fused", **kw)
    torch.cuda.synchronize()
    assert arena_update.KERNEL.launches == launches + 1
    want = ops.arena_block_update(*args, n_seg=n_seg, impl="ref", **kw)
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    assert int(got[1].sum()) > 0


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


def test_arena_router_raises_on_what_the_kernel_refuses(dev):
    B, T, S = 2, 4, 40
    pm = np.zeros((1, S, 1), bool)
    pv = np.zeros((1, S, 1), bool)
    pv[0, 2, 0] = True
    finals = np.zeros((S, 1), bool)
    finals[2] = True
    cells = tuple(torch.full((B, 8, S), -1, dtype=torch.int32, device=dev)
                  for _ in range(4))
    cls = torch.zeros((T, B), dtype=torch.int32, device=dev)
    hits = torch.zeros((T, B, 1), dtype=torch.int32, device=dev)
    ptab = torch.zeros((1, S, 1, 3), dtype=torch.int32, device=dev)
    fin = torch.from_numpy(finals.astype(np.int32)).to(dev)
    lay = kref.arena_block_layout(8, S, 1, 1, 3, 64, (1,), finals, pm, pv)
    with pytest.raises(ValueError, match="det states"):
        ops.arena_block_update(cells, cls, hits, 0, T, lay=lay, ptab=ptab,
                               finals_sq=fin)
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


# (S, NQ, eps, W): the 8/16/32 buckets; rings of exactly ε+1, padded, and
# one too large for shared memory (W·S·4 > 227 KB)
SCAN_CASES = [(5, 1, 6, 7), (12, 3, 9, 16), (28, 4, 40, 41),
              (20, 8, 3000, 3001)]


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
        scan(33, 1, 8, 3)
    with pytest.raises(ValueError, match="queries"):
        scan(12, 9, 8, 3)
    with pytest.raises(ValueError, match="ring"):
        scan(12, 2, 3, 3)
    with pytest.raises(ValueError, match="scalar start_pos"):
        scan(12, 2, 8, 3, start_pos=torch.zeros(B, device=dev))
    with pytest.raises(ValueError, match="at most 31"):
        ops.bitvector(torch.zeros((3, 1), device=dev),
                      [(0, 0, 0.0)] * 32)
    # unfused cer_pipeline calls the scan kernels do not take
    S, C, A, k = 6, 3, 2, 2
    specs, class_of, M, finals, init = random_tables(rng, S, C, A, k, 2)
    args = (torch.zeros((T, B, A), device=dev), specs,
            torch.from_numpy(class_of).to(dev), None,
            torch.from_numpy(M).to(dev), torch.from_numpy(finals).to(dev))
    c0 = torch.zeros((B, 8, S), device=dev)
    init_t = torch.from_numpy(init).to(dev)
    for kw, reason in (
            (dict(start_pos=torch.zeros(B, dtype=torch.int32, device=dev)),
             "per-lane start_pos"),
            (dict(valid_counts=torch.full((B,), T, device=dev)),
             "valid_counts"),
            (dict(latest_q=torch.ones(2, device=dev)), "LAST"),
            (dict(consume_sq=torch.ones((2, S), device=dev)), "CONSUME")):
        with pytest.raises(ValueError, match=reason):
            ops.cer_pipeline(*args, c0, init_mask=init_t, epsilon=5,
                             impl="unfused", **kw)
    window = wkern.DeviceWindow.time(5.0, max_window_events=8)
    with pytest.raises(ValueError, match="time window"):
        ops.cer_pipeline(*args, wkern.init_state(window, B, S, dev),
                         init_mask=init_t, window=window,
                         event_ts=torch.zeros((T, B), device=dev),
                         impl="unfused")
