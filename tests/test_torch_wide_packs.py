"""Packs past 32 states and 8 queries, the unfused reroute and the scan
kernels' ring plan, on the CPU: the port against the JAX package.

The Hopper scan kernels take any pack the reference takes (up to its
``MAX_DET_STATES`` = 512 states, any number of queries); on the CPU every
route runs the plain PyTorch version, which must equal ``repro``'s
``impl="ref"`` / ``use_pallas=False`` exactly — tolerance 0: counts are
f32 integers below 2^24 and hits are positions.  The kernels themselves
are held against the plain versions in ``test_torch_cuda.py`` and
``chip_smoke.py`` on a card.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.events import Event as JEvent
from repro.kernels import ops as j_ops
from repro.kernels.window import DeviceWindow as JWindow
from repro.vector import StreamingVectorEngine as JStreaming
from repro.vector import multiquery as jmq
from repro_torch.core.events import Event as TEvent
from repro_torch.kernels import arena_update as t_arena
from repro_torch.kernels import fused_scan
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels.fused_scan import plan_ring, segments, state_bucket
from repro_torch.kernels.window import DeviceWindow as TWindow
from repro_torch.vector import StreamingVectorEngine as TStreaming
from repro_torch.vector import multiquery as tmq
from repro_torch.vector import tecs_arena

# nine standing queries of the Fig. 8 shape: Ŝ = 63, NQ = 9 (chip_smoke.py
# phase 11 at a small window)
NINE = ("A1 ; A2 ; A3", "B1 ; B2 ; B3", "B4 ; B5 ; B6", "A1 ; B5 ; A3",
        "A2 ; B1 ; B6", "B2 ; A3 ; B4", "B3 ; B6 ; A1", "A3 ; A1 ; B2",
        "B5 ; B4 ; A2")
TYPES = ["A1", "A2", "A3"] + [f"B{i}" for i in range(1, 7)]
# a pack padded to 512 states and 16 query slots over few classes
PAD_QUERIES = ["SELECT * FROM S WHERE A1 ; A2+ ; A3 WITHIN 7 events",
               "SELECT * FROM S WHERE A2 ; A1 WITHIN 7 events"]
PADS = dict(pad_states=512, pad_queries=16)
H100_LIMIT = 220_000   # about what one block may take beside static arrays


def nine_queries(window=12):
    return [f"SELECT * FROM S WHERE {q} WITHIN {window} events"
            for q in NINE]


def make_streams(seed, B, T, types=TYPES):
    rng = np.random.default_rng(seed)
    draws = rng.integers(0, len(types), (B, T))
    return ([[JEvent(types[i]) for i in row] for row in draws],
            [[TEvent(types[i]) for i in row] for row in draws])


def bytes_equal(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


def stream_both(jp, tp, impl, B, T, chunk, seed, types=TYPES):
    """Feed equal streams through the JAX streaming engine and the port's
    over the two packings; return both (counts, hits) and the engines."""
    je = jmq.MultiQueryEngine.from_packing(jp, use_pallas=False)
    te = tmq.MultiQueryEngine.from_packing(tp, impl=impl, device="cpu")
    js, ts = JStreaming(je, chunk, B), TStreaming(te, chunk, B)
    j_ss, t_ss = make_streams(seed, B, T, types)
    out = {"j": [], "t": []}
    for a in range(0, T, chunk):
        out["j"].append(js.feed([s[a:a + chunk] for s in j_ss]))
        out["t"].append(ts.feed([s[a:a + chunk] for s in t_ss]))
    return out, js, ts


@pytest.fixture(scope="module")
def nine_packings():
    return (jmq.build_packing(nine_queries()),
            tmq.build_packing(nine_queries()))


def test_nine_query_packing_equals_reference(nine_packings):
    jp, tp = nine_packings
    assert (tp.num_states, tp.num_queries, tp.num_bits) == (63, 9, 9)
    for name in ("m_all", "finals", "class_of", "init_mask"):
        bytes_equal(getattr(tp.tables, name), getattr(jp.tables, name))
    assert tp.spec() == jp.spec() and tp.fingerprint == jp.fingerprint


@pytest.mark.parametrize("impl", ["fused", "unfused", "ref"])
def test_nine_query_pack_streams_equal_reference(nine_packings, impl):
    jp, tp = nine_packings
    out, js, ts = stream_both(jp, tp, impl, B=3, T=48, chunk=16, seed=4)
    for (jc, jh), (tc, th) in zip(out["j"], out["t"]):
        assert tc.shape[-1] == 9
        np.testing.assert_array_equal(tc, jc)
        assert th == jh
    np.testing.assert_array_equal(ts.snapshot()["arrays"]["state"],
                                  js.snapshot()["arrays"]["state"])
    assert sum(int(c.sum()) for c, _ in out["t"]) > 0


@pytest.mark.parametrize("impl", ["fused", "unfused", "ref"])
def test_padded_512_pack_equals_reference(impl):
    jp = jmq.build_packing(PAD_QUERIES, **PADS)
    tp = tmq.build_packing(PAD_QUERIES, **PADS)
    assert (tp.padded_states, tp.padded_queries) == (512, 16)
    assert tp.num_classes <= 8
    for name in ("m_all", "finals", "class_of", "init_mask"):
        bytes_equal(getattr(tp.tables, name), getattr(jp.tables, name))
    out, js, ts = stream_both(jp, tp, impl, B=2, T=24, chunk=12, seed=7,
                              types=["A1", "A2", "A3", "B1"])
    for (jc, jh), (tc, th) in zip(out["j"], out["t"]):
        assert tc.shape[-1] == 16
        np.testing.assert_array_equal(tc, jc)
        assert th == jh
    assert sum(int(c.sum()) for c, _ in out["t"]) > 0


@pytest.mark.parametrize("what", ["per_lane", "valid", "latest", "consume",
                                  "time"])
def test_rerouted_unfused_calls_on_the_nine_pack(nine_packings, what):
    """The five calls the scan kernels do not take, over the nine-query
    tables: impl="unfused" ≡ impl="fused" ≡ the JAX package's ref."""
    _, tp = nine_packings
    t = tp.tables
    rng = np.random.default_rng(len(what))
    B, T, S, NQ = 3, 10, 63, 9
    enc = tp.encoder
    codes = np.array([enc.vocab["type"][x] for x in TYPES], np.float32)
    attrs = codes[rng.integers(0, len(TYPES), (T, B))][:, :, None]
    kw, W = {}, 16
    c0 = (rng.random((B, W, S)) < 0.05).astype(np.float32)
    if what == "per_lane":
        kw["start_pos"] = np.array([0, 5, 40], np.int32)
    elif what == "valid":
        kw["valid_counts"] = np.array([T, 0, 4], np.int32)
    elif what == "latest":
        kw["latest_q"] = (rng.random(NQ) < 0.5).astype(np.float32)
    elif what == "consume":
        kw["consume_sq"] = np.zeros((NQ, S), np.float32)
        kw["consume_sq"][[0, 8], :] = 1.0
    if what == "time":
        jw = JWindow.time(6.0, max_window_events=W)
        tw = TWindow.time(6.0, max_window_events=W)
        c0 = {"C": c0, "ts": np.full((B, W), -np.inf, np.float32),
              "ovf": np.zeros(B, bool)}
        ts = np.cumsum(rng.integers(0, 3, (T, B)), axis=0).astype(
            np.float32)
        j_kw, t_kw = dict(window=jw, event_ts=jnp.asarray(ts)), \
            dict(window=tw, event_ts=torch.from_numpy(ts))
    else:
        j_kw = {k: jnp.asarray(v) for k, v in kw.items()}
        t_kw = {k: torch.from_numpy(v) for k, v in kw.items()}
        j_kw["epsilon"] = t_kw["epsilon"] = 9

    def j_state(x):
        return ({k: jnp.asarray(v) for k, v in x.items()}
                if isinstance(x, dict) else jnp.asarray(x))

    def t_state(x):
        return ({k: torch.from_numpy(v.copy()) for k, v in x.items()}
                if isinstance(x, dict) else torch.from_numpy(x.copy()))
    jm, jc = j_ops.cer_pipeline(
        jnp.asarray(attrs), enc.specs, jnp.asarray(t.class_of.numpy()),
        jnp.asarray(t.class_ind.numpy()), jnp.asarray(t.m_all.numpy()),
        jnp.asarray(t.finals.numpy()), j_state(c0),
        init_mask=jnp.asarray(t.init_mask.numpy()), impl="ref",
        use_pallas=False, **j_kw)
    outs = [t_ops.cer_pipeline(
        torch.from_numpy(attrs), enc.specs, t.class_of, t.class_ind,
        t.m_all, t.finals, t_state(c0), init_mask=t.init_mask, impl=impl,
        **t_kw) for impl in ("unfused", "fused")]
    for tm, tc in outs:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        if isinstance(tc, dict):
            for k in tc:
                np.testing.assert_array_equal(tc[k].numpy(),
                                              np.asarray(jc[k]))
        else:
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


# ---------------------------------------------------------------------------
# the scan kernels' ring plan (fused_scan.plan_ring, shared by cea_scan)
# ---------------------------------------------------------------------------

# (W, S): phase 8, phase 9, phase 11, the widest pack
@pytest.mark.parametrize("W,S,n", [(3208, 7, 1), (3208, 28, 2),
                                   (3208, 63, 4), (3208, 512, 30)])
def test_scan_plan_at_chip_smoke_geometries(W, S, n):
    """What cea_scan's wrapper asks: count windows, neither LAST nor
    CONSUME, so every ring that does not fit splits."""
    use_smem, got = plan_ring(W, S, False, H100_LIMIT, latest=False,
                              consume=False)
    assert use_smem and got == n
    segs = segments(W, got)
    assert segs[0][0] == 0 and segs[-1][1] == W
    assert all(fused_scan.ring_share_bytes(b - a, S, False) <= H100_LIMIT
               for a, b in segs)


@pytest.mark.parametrize("W,split,n", [(7, 5, 4), (13, 3, 3), (13, 5, 5),
                                       (3208, 5, 5), (3208, 7, 7)])
def test_scan_split_is_trimmed_like_the_kernels_cut(W, split, n):
    use_smem, got = plan_ring(W, 63, False, H100_LIMIT, latest=False,
                              consume=False, split=split)
    assert use_smem and got == n == -(-W // -(-W // split))
    assert all(a < b for a, b in segments(W, got))


@pytest.mark.parametrize("entry", ["cea_scan", "cea_scan_multi"])
def test_scan_router_split_on_cpu(entry):
    """A forced split changes no result: on the CPU it runs the plain
    version, equal to the JAX package's; outside 1..W it is refused."""
    rng = np.random.default_rng(2)
    S, NQ, C, B, T, W, eps = 40, 9, 4, 3, 12, 9, 8
    M = np.zeros((C, S, S), np.float32)
    for s in range(1, S):
        M[:, s, rng.integers(1, S, C)] = 1.0
    finals = (rng.random((NQ, S)) < 0.3).astype(np.float32)
    init = np.zeros(S, np.float32)
    init[1] = 1.0
    ids = rng.integers(0, C, (T, B)).astype(np.int32)
    c0 = (rng.random((B, W, S)) < 0.1).astype(np.float32)
    args = [torch.from_numpy(x) for x in (ids, M, finals, c0)]
    if entry == "cea_scan":
        def run(split):
            return t_ops.cea_scan(args[0], args[1], args[2][0], args[3],
                                  epsilon=eps, start_pos=5, split=split)
        jm, jc = j_ops.cea_scan(
            jnp.asarray(ids), jnp.asarray(M), jnp.asarray(finals[0]),
            jnp.asarray(c0), epsilon=eps, start_pos=5, use_pallas=False)
    else:
        def run(split):
            return t_ops.cea_scan_multi(*args, init_mask=torch.from_numpy(
                init), epsilon=eps, start_pos=5, split=split)
        jm, jc = j_ops.cea_scan_multi(
            jnp.asarray(ids), jnp.asarray(M), jnp.asarray(finals),
            jnp.asarray(c0), init_mask=jnp.asarray(init), epsilon=eps,
            start_pos=5, use_pallas=False)
    for split in (None, 1, 4, W):
        tm, tc = run(split)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for split in (0, W + 1):
        with pytest.raises(ValueError, match="split"):
            run(split)


@pytest.mark.parametrize("S,bucket", [(1, 8), (8, 8), (9, 16), (32, 32),
                                      (33, 512), (63, 512), (512, 512)])
def test_state_buckets(S, bucket):
    assert state_bucket(S) == bucket
    fused_scan.check_launchable(T=4, B=2, S=S, NQ=17, k=3, W=8, epsilon=5,
                                timed=False)


def test_arena_layout_of_the_nine_pack_fits_one_block(nine_packings):
    """The builder stages its layout tables and one step's predecessor
    table in shared memory: smem_bytes counts them as layout_table lays
    them out, and check_launchable refuses what does not fit."""
    te = tmq.MultiQueryEngine.from_packing(nine_packings[1], device="cpu")
    at = te.arena_tables()
    lay = tecs_arena._block_layout(at, te.ring, te.epsilon, 1 << 16)
    assert (lay.S, lay.Q) == (63, 9)
    tab = t_arena.layout_table(lay, tecs_arena._finals(at, "cpu"))
    S, K, Q = lay.S, lay.K, lay.Q
    assert t_arena.smem_bytes(lay) == 4 * (tab.size + S * K * 3 + S + Q)
    t_arena.check_launchable(lay, 16, smem_limit=H100_LIMIT)
    with pytest.raises(ValueError, match="shared memory"):
        t_arena.check_launchable(lay, 16, smem_limit=1024)
