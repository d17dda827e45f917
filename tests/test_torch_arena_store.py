"""The block tECS builder that writes the node store directly, on the CPU:
its plain version against the dense route and against the reference
package (tolerance 0: every value is an int32 node id, a pointer or a
latch).

For each sweep the same chunks, made with numpy from a seed, go through
three routes, chunk after chunk from an empty arena:

* ``repro``'s ``arena_scan_block`` (jitted once per sweep);
* the port's ``arena_scan_block``, whose ``n_seg == 1`` route is
  ``ops.arena_store_update`` — on the CPU the plain store version
  ``ref.arena_store_ref``: ids ranked per step, nodes written to the store;
* the port's dense composition: ``ops.arena_block_update`` (records on
  virtual ids, ``ref.arena_build_ref``) and ``_arena_translate_store``.

Node stores (the sink slot included), cells, pointers, latches and roots
must be identical after every chunk."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.vector import VectorEngine as JVector
from repro.vector import multiquery as jmq
from repro.vector import tecs_arena as jta
from repro_torch.kernels import ops as tops
from repro_torch.vector import VectorEngine as TVector
from repro_torch.vector import multiquery as tmq
from repro_torch.vector import tecs_arena as tta

NINE = ("A1 ; A2 ; A3", "B1 ; B2 ; B3", "B4 ; B5 ; B6", "A1 ; B5 ; A3",
        "A2 ; B1 ; B6", "B2 ; A3 ; B4", "B3 ; B6 ; A1", "A3 ; A1 ; B2",
        "B5 ; B4 ; A2")
QUERIES = [
    "SELECT * FROM S WHERE A ; B ; C",
    "SELECT * FROM S WHERE A ; B+ ; C",
    "SELECT * FROM S WHERE A ; (B OR C) ; A",
    "SELECT * FROM S WHERE B+",
]
LAST = "SELECT LAST * FROM S WHERE A ; B+ ; C WITHIN 9 events"
CONSUME = ("SELECT * FROM S WHERE A ; B+ ; C WITHIN 9 events "
           "CONSUME BY ANY")

# name: query (or "nine"), epsilon, lanes, events, chunk, capacity, extras
SWEEPS = {
    "q0": (QUERIES[0], 9, 2, 32, 32, 1 << 10, {}),
    "q1": (QUERIES[1], 9, 2, 32, 32, 1 << 10, {}),
    "q2": (QUERIES[2], 9, 2, 32, 32, 1 << 10, {}),
    "q3": (QUERIES[3], 9, 2, 32, 32, 1 << 10, {}),
    "straddle": (QUERIES[1], 11, 2, 40, 8, 1 << 10, {}),
    "ragged": (QUERIES[0], 8, 3, 40, 20, 1 << 10, dict(ragged=True)),
    "time": (QUERIES[1], 7, 3, 36, 12, 1 << 10, dict(expire=0.15)),
    "consume": (CONSUME, None, 3, 36, 12, 1 << 10, dict(consume=0.1)),
    "last": (LAST, None, 3, 36, 12, 1 << 10, {}),
    "nine": ("nine", None, 2, 24, 12, 1 << 11, {}),
    # a lane passes capacity in the middle of a later chunk and stays
    # latched
    "overflow": (QUERIES[1], 12, 3, 48, 16, 300, {}),
}


def tables(name):
    query, eps = SWEEPS[name][:2]
    if query == "nine":
        qs = [f"SELECT * FROM S WHERE {q} WITHIN 12 events" for q in NINE]
        je = jmq.MultiQueryEngine(qs, use_pallas=False)
        te = tmq.MultiQueryEngine(qs, device="cpu")
    else:
        je = JVector(query, epsilon=eps, use_pallas=False)
        te = TVector(query, epsilon=eps, device="cpu")
    return je, te


def chunks(name, W, S, Q, C):
    """Per chunk: classes, hits (none on dead steps), starts, valid counts,
    global positions and the optional expire / consume masks."""
    _, _, B, T, ch, _, extra = SWEEPS[name]
    rng = np.random.default_rng(sorted(SWEEPS).index(name))
    cls = rng.integers(0, C, (T, B)).astype(np.int32)
    out = []
    for lo in range(0, T, ch):
        start = np.full(B, lo % W, np.int32)
        valid = np.full(B, ch, np.int32)
        if extra.get("ragged"):
            start = np.array([lo % W, (5 + lo) % W, (11 + lo) % W], np.int32)
            valid = np.array([ch, 9, 0] if lo else [ch, ch, 3], np.int32)
        live = np.arange(ch)[:, None] < valid[None, :]
        hits = (rng.random((ch, B, Q)) < 0.3) & live[:, :, None]
        gpos = np.broadcast_to(lo + np.arange(ch, dtype=np.int32)[:, None],
                               (ch, B)).copy()
        kw = {}
        if "expire" in extra:
            kw["expire"] = rng.random((ch, B, W)) < extra["expire"]
        if "consume" in extra:
            kw["consume"] = rng.random((ch, B, S)) < extra["consume"]
        out.append((cls[lo:lo + ch], hits, start, valid, gpos, kw))
    return out


def as_torch(x):
    return torch.from_numpy(np.ascontiguousarray(x))


_RUNS = {}


def run(name):
    """The three routes over the sweep's chunks (run once per file):
    per chunk, (reference arena, roots), (store route), (dense route)."""
    if name in _RUNS:
        return _RUNS[name]
    je, te = tables(name)
    jt, tt = je.arena_tables(), te.arena_tables()
    eps, B, cap = je.epsilon, SWEEPS[name][2], SWEEPS[name][5]
    W, S, Q = je.ring, tt.num_states, tt.num_queries
    assert (te.ring, te.epsilon) == (W, eps)
    jfun = jax.jit(functools.partial(jta.arena_scan_block, jt,
                                     epsilon=eps))
    ja = jta.init_arena(B, cap, W, jt.num_states)
    store = tta.init_arena(B, cap, W, S)
    dense = tta.init_arena(B, cap, W, S)
    lay = tta._block_layout(tt, W, eps, cap)
    out = []
    for cls, hits, start, valid, gpos, kw in chunks(name, W, S, Q,
                                                    tt.pred_idx.shape[0]):
        ja, jr = jfun(ja, jnp.asarray(cls), jnp.asarray(gpos),
                      jnp.asarray(start), jnp.asarray(valid),
                      jnp.asarray(hits),
                      **{k: jnp.asarray(v) for k, v in kw.items()})
        tkw = {k: as_torch(v) for k, v in kw.items()}
        args = (as_torch(cls), as_torch(gpos), as_torch(start),
                as_torch(valid), as_torch(hits))
        _, sr = tta.arena_scan_block(tt, store, *args, epsilon=eps, **tkw)
        cells0, sstart0 = tta.chunk_cells(dense)
        recs = tops.arena_block_update(
            cells0, args[0], args[4], args[2], args[3], lay=lay,
            ptab=tta._ptab(tt, "cpu"), finals_sq=tta._finals(tt, "cpu"),
            **tkw)
        _, dr = tta._arena_translate_store(dense, lay, *recs, args[1],
                                           args[2], args[3], sstart0,
                                           args[4])
        out.append((({k: np.asarray(v) for k, v in ja.items()},
                     np.asarray(jr)),
                    ({k: v.clone() for k, v in store.items()}, sr),
                    ({k: v.clone() for k, v in dense.items()}, dr)))
    _RUNS[name] = out
    return out


pytestmark = pytest.mark.filterwarnings(
    "ignore:passing epsilon=:DeprecationWarning")
FIELDS = ("kind", "pos", "maxs", "left", "right", "cell", "ptr", "ovf")


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_store_route_equals_dense_route(name):
    """The plain store version ≡ the dense records and their translation,
    sink slot included."""
    for i, (_, (sa, sr), (da, dr)) in enumerate(run(name)):
        for k in FIELDS:
            assert sa[k].dtype == da[k].dtype, (name, i, k)
            assert torch.equal(sa[k], da[k]), f"{name}@{i}:{k}"
        assert sr.dtype == torch.int32 and torch.equal(sr, dr), name


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_store_route_equals_reference(name):
    """The plain store version ≡ repro's arena_scan_block, sink slot,
    pointer and latch included; the chunk allocated something."""
    for i, ((ja, jr), (sa, sr), _) in enumerate(run(name)):
        for k in FIELDS:
            x, y = ja[k], sa[k].numpy()
            assert x.dtype == y.dtype, (name, i, k)
            np.testing.assert_array_equal(x, y, err_msg=f"{name}@{i}:{k}")
        np.testing.assert_array_equal(jr, sr.numpy(),
                                      err_msg=f"{name}@{i}:roots")
    assert int(run(name)[-1][1][0]["ptr"].sum()) > 0
    assert any(int((s[1][1] >= 0).sum()) for s in run(name))


def test_overflow_sweep_passes_capacity_mid_chunk():
    """The overflow sweep does what it is for: in a later chunk a lane
    fills the store up to capacity, writes the sink slot and latches, and
    stays latched with its pointer at the sink, while another lane of that
    chunk stays under capacity."""
    steps = run("overflow")
    ovf = [s[1][0]["ovf"].numpy() for s in steps]
    ptr = [s[1][0]["ptr"].numpy() for s in steps]
    cap = SWEEPS["overflow"][5]
    first = next(i for i, o in enumerate(ovf) if o.any())
    assert first > 0 and not ovf[first].all()
    lane = int(np.nonzero(ovf[first])[0][0])
    p0 = int(ptr[first - 1][lane])
    assert p0 < cap
    kind = steps[first][1][0]["kind"].numpy()[lane]
    assert (kind[p0:cap + 1] >= 0).all()     # filled up to the sink
    assert all(o[lane] for o in ovf[first:])
    assert all(p[lane] == cap for p in ptr[first:])
