"""The port's block tECS builder and node store against the reference
package's, on the CPU (tolerance 0: every value is an int32 node id, a
record flag or a pointer).

The same inputs, made with numpy from a seed, go through ``repro`` (its
jnp ``ref`` oracles, its Pallas kernel in interpret mode, its per-event
fold) and through ``repro_torch`` (the plain PyTorch versions)."""
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.events import Event as JEvent
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.vector import VectorEngine as JVector
from repro.vector import tecs_arena as jta
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.vector import ArenaOverflow as TOverflow
from repro_torch.vector import VectorEngine as TVector
from repro_torch.vector import tecs_arena as tta

QUERIES = [
    "SELECT * FROM S WHERE A ; B ; C",
    "SELECT * FROM S WHERE A ; B+ ; C",
    "SELECT * FROM S WHERE A ; (B OR C) ; A",
    "SELECT * FROM S WHERE B+",
]
K5 = "SELECT * FROM S WHERE A1 ; A2+ ; A3 ; A4+ ; A5 WITHIN 100 events"

pytestmark = pytest.mark.filterwarnings(
    "ignore:passing epsilon=:DeprecationWarning")


def engines(query, eps=None):
    return (JVector(query, epsilon=eps, use_pallas=False),
            TVector(query, epsilon=eps, device="cpu"))


def type_streams(seed, B, T, alphabet="ABCX"):
    rng = random.Random(seed)
    return [[rng.choice(alphabet) for _ in range(T)] for _ in range(B)]


def t(x, dtype=None):
    """A reference-package array as a torch tensor (a copy)."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def counting(je, types, eps, start=0, valid=None):
    """The reference counting pipeline (ref impl) over encoded streams:
    (matches, class trace) as numpy."""
    attrs = jnp.asarray(je.encoder.encode_streams(
        [[JEvent(x) for x in s] for s in types]))
    tb = je.tables
    m, _, trace = jops.cer_pipeline(
        attrs, je.encoder.specs, tb.class_of, tb.class_ind, tb.m_all,
        tb.finals[None, :], je.init_state(attrs.shape[1]),
        init_mask=tb.init_mask, epsilon=eps, start_pos=start,
        valid_counts=valid, impl="ref", return_trace=True)
    return np.asarray(m), np.asarray(trace)


def assert_arena_equal(ja, ta, cap, what=""):
    """Stores (sink excluded), cells, pointers and latches bit-equal."""
    for k in ("ptr", "ovf", "cell"):
        x, y = np.asarray(ja[k]), ta[k].numpy()
        assert x.dtype == y.dtype, (what, k)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}:{k}")
    for k in ("kind", "pos", "maxs", "left", "right"):
        np.testing.assert_array_equal(np.asarray(ja[k])[:, :cap],
                                      ta[k].numpy()[:, :cap],
                                      err_msg=f"{what}:{k}")


# ---------------------------------------------------------------------------
# static layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("query", QUERIES + [K5])
def test_layout_parity(query):
    eps = None if "WITHIN" in query else 9
    je, te = engines(query, eps)
    jt, tt = je.arena_tables(), te.arena_tables()
    for k in ("pred_idx", "pred_mark", "pred_valid", "finals_sq"):
        np.testing.assert_array_equal(np.asarray(getattr(jt, k)),
                                      getattr(tt, k), err_msg=k)
    assert (jt.init_states, jt.num_states, jt.num_queries,
            jt.max_indegree) == (tt.init_states, tt.num_states,
                                 tt.num_queries, tt.max_indegree)
    cap = 1 << 12
    jl = jta._block_layout(jt, je.ring, je.epsilon, cap)
    tl = tta._block_layout(tt, te.ring, te.epsilon, cap)
    for f in ("W", "S", "K", "Q", "epsilon", "cap", "init_states",
              "fin_states", "ext_states", "uni_states", "off_bottom",
              "off_ext", "off_uni", "off_fs", "off_chain", "M", "E",
              "voffset"):
        assert getattr(jl, f) == getattr(tl, f), f
    for f in ("kind_static", "w_static", "d_static", "pos_is_event"):
        np.testing.assert_array_equal(getattr(jl, f)(), getattr(tl, f)(),
                                      err_msg=f)
    np.testing.assert_array_equal(
        jref.pack_pred_tables(jt.pred_idx, jt.pred_mark, jt.pred_valid),
        tref.pack_pred_tables(tt.pred_idx, tt.pred_mark, tt.pred_valid))
    if query == K5:
        assert (tl.S, tl.K, len(tl.fin_states)) == (26, 18, 8)


# ---------------------------------------------------------------------------
# the builder: plain version against the reference's jnp oracle
# ---------------------------------------------------------------------------


BUILDER_CASES = ["count", "seg2", "masks_ragged"]


@pytest.mark.parametrize("case", BUILDER_CASES)
def test_builder_parity(case):
    """Random chunk-start cells, counting-scan traces and hits (zero on
    dead steps, as the counting scan leaves them): records, roots and
    cells equal the reference's ``ref.arena_build_ref``.  ``masks_ragged``
    adds a time-eviction mask, a CONSUME mask, per-lane offsets (one at
    0) and a dead lane."""
    eps, B, T = 6, 3, 16
    je, te = engines(QUERIES[1], eps)
    at = je.arena_tables()
    cap = 1 << 9
    lay_j = jta._block_layout(at, je.ring, eps, cap)
    lay_t = tta._block_layout(te.arena_tables(), te.ring, eps, cap)
    W, S, Q = lay_j.W, lay_j.S, lay_j.Q
    rng = np.random.default_rng(BUILDER_CASES.index(case))
    cid = rng.integers(0, cap, (B, W, S)).astype(np.int32)
    cid[rng.random((B, W, S)) < 0.6] = -1
    cells0 = (cid, rng.integers(0, 2, (B, W, S)).astype(np.int32),
              rng.integers(-1, cap, (B, W, S)).astype(np.int32),
              rng.integers(-1, cap, (B, W, S)).astype(np.int32))
    start = np.zeros(B, np.int32)
    valid = np.full(B, T, np.int32)
    if case == "masks_ragged":
        start = np.array([0, 5, 11], np.int32)
        valid = np.array([T, 9, 0], np.int32)
    _, trace = counting(je, type_streams(7, B, T), eps, start=0)
    hits = rng.random((T, B, Q)) < 0.3
    hits &= (np.arange(T)[:, None] < valid[None, :])[:, :, None]
    expire = consume = None
    kw_j, kw_t = {}, {}
    if case == "masks_ragged":
        expire = rng.random((T, B, W)) < 0.2
        kw_j["expire"], kw_t["expire"] = jnp.asarray(expire), t(expire)
        consume = rng.random((T, B, S)) < 0.1
        kw_j["consume"], kw_t["consume"] = jnp.asarray(consume), t(consume)
    n_seg = 2 if case == "seg2" else 1
    want = jref.arena_build_ref(
        tuple(jnp.asarray(c) for c in cells0), jnp.asarray(trace),
        jnp.asarray(hits), jnp.asarray(start), jnp.asarray(valid),
        lay=lay_j, ptab=jta._ptab(at), finals_sq=at.finals_sq, n_seg=n_seg,
        **kw_j)
    got = tops.arena_block_update(
        tuple(t(c) for c in cells0), t(trace), t(hits), t(start), t(valid),
        lay=lay_t, ptab=tta._ptab(te.arena_tables(), "cpu"),
        finals_sq=tta._finals(te.arena_tables(), "cpu"), n_seg=n_seg,
        **kw_t)
    for i, c in enumerate(want[0]):
        np.testing.assert_array_equal(np.asarray(c), got[0][i].numpy(),
                                      err_msg=f"cells[{i}]")
    for name, w, g in zip(("valid", "left", "right", "roots"), want[1:],
                          got[1:]):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(np.asarray(w), g.numpy(),
                                      err_msg=name)
    assert int(got[1].sum()) > 0          # the chunk allocated something


def test_segment_operands_and_slot_starts():
    eps, B, T = 3, 2, 24
    je, te = engines(QUERIES[0], eps)
    lay_j = jta._block_layout(je.arena_tables(), je.ring, eps, 64)
    lay_t = tta._block_layout(te.arena_tables(), te.ring, eps, 64)
    rng = np.random.default_rng(5)
    cls = rng.integers(0, 4, (T, B)).astype(np.int32)
    hits = rng.random((T, B, 1)) < 0.5
    start = np.array([0, 7], np.int32)
    valid = np.array([T, 13], np.int32)
    cells = tuple(np.full((B, lay_j.W, lay_j.S), -1, np.int32)
                  for _ in range(4))
    xs_j, c_j = jref.segment_operands(
        tuple(map(jnp.asarray, cells)), jnp.asarray(cls), jnp.asarray(hits),
        jnp.asarray(start), jnp.asarray(valid), lay=lay_j, n_seg=3)
    xs_t, c_t = tref.segment_operands(
        tuple(map(t, cells)), t(cls), t(hits), t(start), t(valid),
        lay=lay_t, n_seg=3)
    for a, b in zip(xs_j + c_j, xs_t + c_t):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int32),
                                      b.numpy())
    gpos = np.cumsum(rng.integers(0, 3, (T, B)), axis=0).astype(np.int32)
    s0 = rng.integers(-1, 50, (B, lay_j.W)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jref.arena_slot_starts(
            jnp.asarray(s0), jnp.asarray(gpos), jnp.asarray(start),
            jnp.asarray(valid), W=lay_j.W)),
        tref.arena_slot_starts(t(s0), t(gpos), t(start), t(valid),
                               W=lay_t.W).numpy())
    assert tref.pick_segments(T, lay_t.W) == jref.pick_segments(T, lay_j.W)


# ---------------------------------------------------------------------------
# the node store: block and fold against the reference's
# ---------------------------------------------------------------------------


def run_both(query, types, eps, *, chunk=None, cap=1 << 10, start=None,
             valid=None, impls=("block",), **jax_block_kw):
    """Feed chunks through the reference's and the port's arena scans
    (each ``impl`` of the port against the same of the reference, jitted
    once) and assert bit-equal stores and roots after every chunk."""
    je, te = engines(query, eps)
    jt, tt = je.arena_tables(), te.arena_tables()
    jfun = {"block": jax.jit(functools.partial(
                jta.arena_scan_block, jt, epsilon=eps, **jax_block_kw)),
            "fold": jax.jit(functools.partial(jta.arena_scan, jt,
                                              epsilon=eps))}
    B, T = len(types), len(types[0])
    chunk = chunk or T
    arenas = {impl: (jta.init_arena(B, cap, je.ring, jt.num_states),
                     tta.init_arena(B, cap, te.ring, tt.num_states))
              for impl in impls}
    state = je.init_state(B)
    attrs = jnp.asarray(je.encoder.encode_streams(
        [[JEvent(x) for x in s] for s in types]))
    tb = je.tables
    for lo in range(0, T, chunk):
        m, state, trace = jops.cer_pipeline(
            attrs[lo:lo + chunk], je.encoder.specs, tb.class_of,
            tb.class_ind, tb.m_all, tb.finals[None, :], state,
            init_mask=tb.init_mask, epsilon=eps,
            start_pos=lo % je.ring if start is None else start,
            valid_counts=valid, impl="ref", return_trace=True)
        ch = trace.shape[0]
        gpos = np.broadcast_to(lo + np.arange(ch, dtype=np.int32)[:, None],
                               (ch, B))
        s = (np.full(B, lo % je.ring, np.int32) if start is None
             else np.asarray(start, np.int32))
        v = np.full(B, ch, np.int32) if valid is None else valid
        hits = np.asarray(m) > 0.5
        for impl, (ja, ta) in arenas.items():
            ja, jr = jfun[impl](ja, trace, jnp.asarray(gpos),
                                jnp.asarray(s), jnp.asarray(v),
                                jnp.asarray(hits))
            tfun = tta.arena_scan_block if impl == "block" else tta.arena_scan
            ta, tr = tfun(tt, ta, t(trace), t(gpos), t(s), t(v), t(hits),
                          epsilon=eps)
            arenas[impl] = (ja, ta)
            assert_arena_equal(ja, ta, cap, f"{impl}@{lo}")
            np.testing.assert_array_equal(np.asarray(jr), tr.numpy(),
                                          err_msg=f"{impl}@{lo}:roots")
    return {impl: ta for impl, (_, ta) in arenas.items()}


@pytest.mark.parametrize("qidx", range(len(QUERIES)))
def test_store_parity_query_sweep(qidx):
    """The port's per-event fold equals the reference's, and the port's
    block store equals its fold's (the reference's block store is held
    against its fold by the reference's own tests, and against the port's
    block store by the tests below)."""
    types = type_streams(137 + qidx, 2, 32)
    out = run_both(QUERIES[qidx], types, 9, impls=("fold",))
    te = engines(QUERIES[qidx], 9)[1]
    m, trace = counting(engines(QUERIES[qidx], 9)[0], types, 9)
    T, B = trace.shape
    ta = tta.init_arena(B, 1 << 10, te.ring, te.arena_tables().num_states)
    gpos = np.broadcast_to(np.arange(T, dtype=np.int32)[:, None], (T, B))
    tta.arena_scan_block(te.arena_tables(), ta, t(trace), t(gpos),
                         torch.zeros(B, dtype=torch.int32),
                         torch.full((B,), T, dtype=torch.int32),
                         t(m > 0.5), epsilon=9)
    assert int(ta["ptr"].sum()) > 0
    assert_arena_equal({k: v.numpy() for k, v in out["fold"].items()},
                       ta, 1 << 10, "block vs fold")


def test_store_parity_chunk_straddle():
    """Chunks far smaller than the window: carried cells cross every
    chunk boundary, exercising the store-derived cell attributes."""
    run_both(QUERIES[1], type_streams(21, 2, 40), 11, chunk=8)


def test_store_parity_ragged_lanes():
    run_both(QUERIES[0], type_streams(5, 3, 40), 8,
             start=np.array([0, 5, 11], np.int32),
             valid=np.array([40, 17, 0], np.int32))


def test_store_parity_against_pallas_interpret():
    """The reference's Pallas builder kernel in interpret mode runs the
    same step as its jnp oracle; the port's store equals it."""
    run_both(QUERIES[1], type_streams(3, 2, 16), 6, use_pallas=True,
             interpret=True, b_tile=2)


def test_overflow_latch_matches_reference():
    """A lane past capacity latches ``ovf`` and refuses to enumerate; the
    lane under capacity stays bit-exact (sink excluded)."""
    eps, T, cap = 12, 64, 128
    types = (type_streams(3, 1, T, alphabet="ABBC")
             + type_streams(9, 1, T, alphabet="AXCX"))
    je, te = engines(QUERIES[1], eps)
    m, trace = counting(je, types, eps)
    gpos = np.broadcast_to(np.arange(T, dtype=np.int32)[:, None], (T, 2))
    args_j = (trace, jnp.asarray(gpos), jnp.zeros(2, jnp.int32),
              jnp.full((2,), T, jnp.int32), jnp.asarray(m > 0.5))
    args_t = (t(trace), t(gpos), torch.zeros(2, dtype=torch.int32),
              torch.full((2,), T, dtype=torch.int32), t(m > 0.5))
    # the port's fold against the reference's block store: on the lane
    # under capacity the two implementations agree bit for bit
    ja, jr = jta.arena_scan_block(
        je.arena_tables(),
        jta.init_arena(2, cap, je.ring, je.arena_tables().num_states),
        *args_j, epsilon=eps)
    for tf in (tta.arena_scan_block, tta.arena_scan):
        ta, tr = tf(te.arena_tables(),
                    tta.init_arena(2, cap, te.ring,
                                   te.arena_tables().num_states),
                    *args_t, epsilon=eps)
        ovf = ta["ovf"].numpy()
        assert ovf[0] and not ovf[1]
        np.testing.assert_array_equal(np.asarray(ja["ovf"]), ovf)
        np.testing.assert_array_equal(np.asarray(ja["ptr"]),
                                      ta["ptr"].numpy())
        for k in ("kind", "pos", "maxs", "left", "right"):
            np.testing.assert_array_equal(np.asarray(ja[k])[1, :cap],
                                          ta[k].numpy()[1, :cap], err_msg=k)
        np.testing.assert_array_equal(np.asarray(jr)[:, 1],
                                      tr.numpy()[:, 1])
        snap = tta.ArenaSnapshot(ta)
        roots = tr.numpy()
        step = int(np.nonzero(roots[:, 0, 0] >= 0)[0][0])
        with pytest.raises(TOverflow):
            list(snap.enumerate(0, roots[step, 0, 0], step))
        with pytest.raises(TOverflow):
            snap.enumerate_batch([0], [int(roots[step, 0, 0])], [step])
