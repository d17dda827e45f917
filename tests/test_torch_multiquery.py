"""The port's packed MultiQueryEngine against the reference package's.

On the CPU the port's packed engine runs the plain PyTorch versions.  Its
packing tables, specs and fingerprints must be byte-identical to
``repro``'s, its counts, enumerated sets and snapshot migrations equal —
tolerance 0 (counts are f32 integers below 2^24, node ids int32).
Snapshots restore across the two packages in both directions.
"""
import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.events import Event as JEvent
from repro.vector import StreamingVectorEngine as JStreaming
from repro.vector import multiquery as jmq
from repro.vector.streaming import migrate_packed_arrays as j_migrate
from repro_torch.core.events import Event as TEvent
from repro_torch.vector import StreamingVectorEngine as TStreaming
from repro_torch.vector import VectorEngine as TVector
from repro_torch.vector import multiquery as tmq
from repro_torch.vector.streaming import migrate_packed_arrays as t_migrate

QUERIES = [
    "SELECT * FROM S WHERE A ; B ; C",
    "SELECT * FROM S WHERE A ; B+ ; C",
    "SELECT * FROM S WHERE A ; (B OR C) ; A",
    "SELECT * FROM S WHERE B ; C",
]
MIXED = [
    "SELECT LAST * FROM S WHERE A ; B WITHIN 9 events",
    "SELECT * FROM S WHERE A ; B ; C WITHIN 9 events CONSUME BY ANY",
    "SELECT * FROM S WHERE B ; C WITHIN 9 events",
]
PADS = dict(pad_states=32, pad_queries=8,
            pad_classes=lambda c: 1 << c.bit_length(),
            pad_bits=lambda k: k + 1)


def make_streams(seed, B, T, alphabet="ABCX"):
    """Equal event streams for both packages."""
    rng = random.Random(seed)
    types = [[rng.choice(alphabet) for _ in range(T)] for _ in range(B)]
    return ([[JEvent(x) for x in s] for s in types],
            [[TEvent(x) for x in s] for s in types])


def host(x):
    if x is None:
        return None
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def bytes_equal(a, b):
    a, b = host(a), host(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype,
                                                        b.shape, b.dtype)
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# packing tables, specs, fingerprints and invariants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("queries", [QUERIES[:2], QUERIES, MIXED],
                         ids=["nq2", "nq4", "mixed"])
def test_packing_is_byte_identical(queries, padded):
    pads = PADS if padded else {}
    qids = tuple(f"id{i}" for i in range(len(queries)))
    jp = jmq.build_packing(queries, qids=qids, **pads)
    tp = tmq.build_packing(queries, qids=qids, **pads)
    for name in ("m_all", "finals", "class_of", "class_ind", "init_mask",
                 "reps"):
        bytes_equal(getattr(tp.tables, name), getattr(jp.tables, name))
    for name in ("latest_q", "consume_sq"):
        a, b = getattr(tp.tables, name), getattr(jp.tables, name)
        assert (a is None) == (b is None), name
        if a is not None:
            bytes_equal(a, b)
    for name in ("qids", "queries", "offsets", "sizes", "num_states",
                 "padded_states", "num_queries", "padded_queries",
                 "num_classes", "padded_classes", "num_bits", "padded_bits",
                 "strategies", "consumes"):
        assert getattr(tp, name) == getattr(jp, name), name
    assert tp.tables.offsets == jp.tables.offsets
    assert tp.encoder.specs == jp.encoder.specs
    assert tp.spec() == jp.spec()
    assert tp.table_fingerprint == jp.table_fingerprint
    assert tp.fingerprint == jp.fingerprint
    np.testing.assert_array_equal(tp.query_of_state(), jp.query_of_state())
    tmq.check_packing_invariants(tp)
    jmq.check_packing_invariants(jp)


def _corrupt_table(name, fn):
    def apply(pk, to_arr):
        arr = np.array(host(getattr(pk.tables, name)))
        fn(arr, pk)
        setattr(pk.tables, name, to_arr(arr))
    return apply


def _set_field(name, fn):
    def apply(pk, to_arr):
        setattr(pk, name, fn(getattr(pk, name)))
    return apply


def _drop_latest(pk, to_arr):
    pk.tables.latest_q = None


CORRUPTIONS = {
    "padded_state_transition": _corrupt_table(
        "m_all", lambda m, pk: m.__setitem__((0, pk.num_states, 1), 1.0)),
    "padded_class_matrix": _corrupt_table(
        "m_all", lambda m, pk: m.__setitem__((pk.num_classes, 1, 1), 1.0)),
    "block_mismatch": _corrupt_table(
        "m_all", lambda m, pk: m.__setitem__((0, 1, 1), m[0, 1, 1] + 1.0)),
    "padded_seed": _corrupt_table(
        "init_mask", lambda a, pk: a.__setitem__(pk.num_states, 1.0)),
    "padded_state_finals": _corrupt_table(
        "finals", lambda a, pk: a.__setitem__((0, pk.num_states), 1.0)),
    "padded_query_finals": _corrupt_table(
        "finals", lambda a, pk: a.__setitem__((pk.num_queries, 1), 1.0)),
    "padded_class_of": _corrupt_table(
        "class_of", lambda a, pk: a.__setitem__(1 << pk.num_bits, 1)),
    "offsets": _set_field("offsets", lambda o: (0,) + tuple(
        x + 1 for x in o[1:])),
    "sizes": _set_field("sizes", lambda s: (s[0] + 1,) + tuple(s[1:])),
    "latest_missing": _drop_latest,
}


@pytest.mark.parametrize("what", sorted(CORRUPTIONS))
def test_invariants_reject_the_same_corruptions(what):
    jp = jmq.build_packing(MIXED, **PADS)
    tp = tmq.build_packing(MIXED, **PADS)
    CORRUPTIONS[what](jp, jnp.asarray)
    CORRUPTIONS[what](tp, torch.from_numpy)
    with pytest.raises(jmq.PackingInvariantError) as j_err:
        jmq.check_packing_invariants(jp)
    with pytest.raises(tmq.PackingInvariantError) as t_err:
        tmq.check_packing_invariants(tp)
    assert str(t_err.value) == str(j_err.value)


def test_engine_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        assert tmq.MultiQueryEngine(QUERIES[:2], epsilon=5).device.type == \
            "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmq.MultiQueryEngine(QUERIES[:2], epsilon=5)
    assert tmq.MultiQueryEngine(QUERIES[:2], epsilon=5,
                                device="cpu").tables.m_all.device.type == \
        "cpu"


def test_packing_refusals_equal_reference():
    for kw in (dict(queries=[]), dict(queries=QUERIES[:2], qids=("a", "a")),
               dict(queries=QUERIES[:2], pad_states=3)):
        with pytest.raises(ValueError) as j_err:
            jmq.build_packing(**kw)
        with pytest.raises(ValueError) as t_err:
            tmq.build_packing(**kw)
        assert str(t_err.value) == str(j_err.value)
    mixed_windows = ["SELECT * FROM S WHERE A ; B WITHIN 5 events",
                     "SELECT * FROM S WHERE B ; C WITHIN 6 events"]
    with pytest.raises(ValueError, match="one window"):
        tmq.MultiQueryEngine(mixed_windows, device="cpu")


# ---------------------------------------------------------------------------
# counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nq", [2, 4])
def test_packed_run_equals_reference(nq):
    queries = QUERIES[:nq]
    j_ss, t_ss = make_streams(9, 3, 40)
    jm, _ = jmq.MultiQueryEngine(queries, epsilon=7,
                                 use_pallas=False).run(j_ss)
    assert jm.shape == (40, 3, nq)
    for impl in ("fused", "unfused", "ref"):
        te = tmq.MultiQueryEngine(queries, epsilon=7, impl=impl,
                                  device="cpu")
        tm, _ = te.run(t_ss)
        assert tm.dtype == np.int64
        np.testing.assert_array_equal(tm, jm)
    # each query's column equals its own single-query engine
    for qi, q in enumerate(queries):
        single, _ = TVector(q, epsilon=7, device="cpu").run(t_ss)
        np.testing.assert_array_equal(jm[:, :, qi], single)


def test_packed_chunked_carry_and_classify_scan():
    queries = QUERIES[:3]
    j_ss, t_ss = make_streams(2, 2, 48)
    full, _ = jmq.MultiQueryEngine(queries, epsilon=6,
                                   use_pallas=False).run(j_ss)
    te = tmq.MultiQueryEngine(queries, epsilon=6, device="cpu")
    state, parts, scan_state, scan_parts = None, [], te.init_state(2), []
    for lo in range(0, 48, 12):
        chunk = [s[lo:lo + 12] for s in t_ss]
        m, state = te.run(chunk, state=state, start_pos=lo)
        parts.append(m)
        ids = te.classify(te.encode_ts(chunk)[0])
        sm, scan_state = te.scan(ids, scan_state, start_pos=lo)
        scan_parts.append(sm.numpy())
    np.testing.assert_array_equal(np.concatenate(parts), full)
    np.testing.assert_array_equal(np.concatenate(scan_parts), full)
    assert torch.equal(scan_state, state)


def test_blocks_do_not_interact():
    queries = ["SELECT * FROM S WHERE A ; A ; A ; A ; A",
               "SELECT * FROM S WHERE Z1 ; Z2"]   # Z types never occur
    te = tmq.MultiQueryEngine(queries, epsilon=10, device="cpu")
    m, _ = te.run([[TEvent("A") for _ in range(20)]])
    assert m[:, 0, 0].sum() > 0
    assert m[:, 0, 1].sum() == 0
    jm, _ = jmq.MultiQueryEngine(queries, epsilon=10, use_pallas=False).run(
        [[JEvent("A") for _ in range(20)]])
    np.testing.assert_array_equal(m, jm)


@pytest.mark.parametrize("impl", ["fused", "unfused"])
def test_mixed_semantics_pack_through_pipeline(impl):
    """LAST and CONSUME BY ANY members evaluate through pipeline(); scan()
    refuses them, as in the reference package."""
    j_ss, t_ss = make_streams(5, 3, 30)
    je = jmq.MultiQueryEngine(MIXED, use_pallas=False)
    te = tmq.MultiQueryEngine(MIXED, impl=impl, device="cpu")
    jm, _ = je.run(j_ss)
    tm, _ = te.run(t_ss)
    np.testing.assert_array_equal(tm, jm)
    assert jm[..., 0].sum() > 0 and jm[..., 1].sum() > 0
    ids = np.zeros((4, 3), np.int32)
    with pytest.raises(ValueError) as j_err:
        je.scan(jnp.asarray(ids), je.init_state(3))
    with pytest.raises(ValueError) as t_err:
        te.scan(torch.from_numpy(ids), te.init_state(3))
    assert str(t_err.value) == str(j_err.value)


def test_time_window_pack_equals_reference():
    queries = ["SELECT * FROM S WHERE A ; B WITHIN 6 seconds",
               "SELECT * FROM S WHERE B ; C WITHIN 6 seconds"]
    rng = random.Random(3)
    types = [[rng.choice("ABCX") for _ in range(24)] for _ in range(2)]
    ts = [[float(t // 2) for t in range(24)] for _ in range(2)]
    j_ss = [[JEvent(x, {}, timestamp=t) for x, t in zip(s, u)]
            for s, u in zip(types, ts)]
    t_ss = [[TEvent(x, {}, timestamp=t) for x, t in zip(s, u)]
            for s, u in zip(types, ts)]
    jm, js = jmq.MultiQueryEngine(queries, max_window_events=16,
                                  use_pallas=False).run(j_ss)
    te = tmq.MultiQueryEngine(queries, max_window_events=16, device="cpu")
    tm, tstate = te.run(t_ss)
    np.testing.assert_array_equal(tm, jm)
    for k in js:
        np.testing.assert_array_equal(tstate[k].numpy(), np.asarray(js[k]))
    with pytest.raises(ValueError, match="scan()"):
        te.scan(torch.zeros((2, 2), dtype=torch.int32), te.init_state(2))


# ---------------------------------------------------------------------------
# enumeration over the packed arena
# ---------------------------------------------------------------------------


def ceset(ces):
    return sorted((int(c.start), int(c.end), tuple(map(int, c.data)))
                  for c in ces)


def test_packed_run_enumerate_equals_reference():
    queries = QUERIES[:3]
    j_ss, t_ss = make_streams(4, 2, 24)
    jc, jres = jmq.MultiQueryEngine(queries, epsilon=7,
                                    use_pallas=False).run_enumerate(
        j_ss, arena_capacity=1 << 12)
    te = tmq.MultiQueryEngine(queries, epsilon=7, device="cpu")
    tc, tres = te.run_enumerate(t_ss, arena_capacity=1 << 12)
    np.testing.assert_array_equal(tc, jc)
    assert tres.keys() == jres.keys() and len(tres) > 0
    for key in tres:
        assert ceset(tres[key]) == ceset(jres[key]), key
        assert len(tres[key]) == tc[key]
    tbl_j = jmq.MultiQueryEngine(queries, epsilon=7,
                                 use_pallas=False).arena_tables()
    tbl_t = te.arena_tables()
    for name in ("pred_idx", "pred_mark", "pred_valid", "finals_sq"):
        bytes_equal(getattr(tbl_t, name), getattr(tbl_j, name))
    assert tbl_t.init_states == tbl_j.init_states


# ---------------------------------------------------------------------------
# packed snapshots: across the packages, and across packings
# ---------------------------------------------------------------------------

WQ = [q + " WITHIN 7 events" for q in QUERIES]


def assert_snapshots_equal(ja, ta):
    assert ja.keys() == ta.keys()
    for k in ja:
        assert ja[k].dtype == ta[k].dtype, k
        np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_packed_snapshot_restores_across_packages(direction):
    B, T = 2, 12
    j_ss, t_ss = make_streams(6, B, 3 * T)
    js = JStreaming(jmq.MultiQueryEngine(WQ[:3], use_pallas=False), T, B)
    ts = TStreaming(tmq.MultiQueryEngine(WQ[:3], impl="unfused",
                                         device="cpu"), T, B)
    src, dst = (js, ts) if direction == "jax_to_torch" else (ts, js)
    src_ss = j_ss if src is js else t_ss
    src.feed([s[:T] for s in src_ss])
    snap = src.snapshot()
    assert snap["meta"]["packing"] == ts.engine.packing.spec()
    dst.restore(snap)
    assert dst.position == T
    if dst is js:   # bring the source package's engine along
        ts.restore(snap)
    else:
        js.restore(snap)
    for lo in (T, 2 * T):
        jc, jh = js.feed([s[lo:lo + T] for s in j_ss])
        tc, th = ts.feed([s[lo:lo + T] for s in t_ss])
        assert tc.shape == (T, B, 3)
        np.testing.assert_array_equal(tc, jc)
        assert th == jh
    assert_snapshots_equal(js.snapshot()["arrays"], ts.snapshot()["arrays"])
    assert js.manifest()["query_fingerprint"] == \
        ts.manifest()["query_fingerprint"]


def test_migrate_packed_arrays_equals_reference():
    """The arena-carrying snapshot of a packed engine migrates onto another
    packing (a query removed, one added, the rest reordered and padded)
    exactly as the reference package migrates it."""
    B, T = 2, 16
    _, t_ss = make_streams(8, B, T)
    old = tmq.build_packing(WQ[:3], qids=("a", "b", "c"))
    new = tmq.build_packing([WQ[2], WQ[3], WQ[0]], qids=("c", "d", "a"),
                            pad_states=24)
    ts = TStreaming(tmq.MultiQueryEngine.from_packing(old, device="cpu"), T,
                    B, arena_capacity=1 << 12)
    ts.feed(t_ss)
    snap = ts.snapshot()
    assert "roots_val" in snap["arrays"]
    got = t_migrate(snap["arrays"], old.spec(), new.spec())
    want = j_migrate(snap["arrays"], old.spec(), new.spec())
    assert_snapshots_equal(want, got)
    # a changed state count refuses in both packages
    bad = dict(new.spec(), sizes=[9, 9, 9])
    with pytest.raises(ValueError) as j_err:
        j_migrate(snap["arrays"], old.spec(), bad)
    with pytest.raises(ValueError) as t_err:
        t_migrate(snap["arrays"], old.spec(), bad)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("source", ["jax", "torch"])
def test_restore_migrate_packing_equals_reference(source):
    """restore(migrate_packing=True) onto a repacked engine continues as the
    reference package's does, and each surviving query as its own single
    engine."""
    B, T = 2, 12
    j_ss, t_ss = make_streams(12, B, 2 * T)
    old_q, old_id = WQ[:3], ("a", "b", "c")
    new_q, new_id = [WQ[2], WQ[3], WQ[0]], ("c", "d", "a")
    j_old = JStreaming(jmq.MultiQueryEngine.from_packing(
        jmq.build_packing(old_q, qids=old_id), use_pallas=False), T, B)
    t_old = TStreaming(tmq.MultiQueryEngine.from_packing(
        tmq.build_packing(old_q, qids=old_id), device="cpu"), T, B)
    j_old.feed([s[:T] for s in j_ss])
    t_old.feed([s[:T] for s in t_ss])
    snap = (j_old if source == "jax" else t_old).snapshot()
    j_new = JStreaming(jmq.MultiQueryEngine.from_packing(
        jmq.build_packing(new_q, qids=new_id, pad_states=24),
        use_pallas=False), T, B)
    t_new = TStreaming(tmq.MultiQueryEngine.from_packing(
        tmq.build_packing(new_q, qids=new_id, pad_states=24),
        device="cpu"), T, B)
    with pytest.raises(ValueError, match="incompatible"):
        t_new.restore(snap)
    j_new.restore(snap, migrate_packing=True)
    t_new.restore(snap, migrate_packing=True)
    assert_snapshots_equal(j_new.snapshot()["arrays"],
                           t_new.snapshot()["arrays"])
    jc, _ = j_new.feed([s[T:] for s in j_ss])
    tc, _ = t_new.feed([s[T:] for s in t_ss])
    np.testing.assert_array_equal(tc, jc)
    # the surviving queries continue as single engines over the whole stream
    for slot, q in ((0, WQ[2]), (2, WQ[0])):
        single, _ = TVector(q, device="cpu").run(t_ss)
        np.testing.assert_array_equal(tc[:, :, slot], single[T:])
