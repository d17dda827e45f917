"""The port's PARTITION BY engine and its lane router against the reference
package's, on the CPU route.

The same interleaved streams, made from seeds, go through
``repro.vector.PartitionedStreamingEngine`` (its plain path, as
``tests/test_partitioned_stream.py`` runs it) and
``repro_torch.vector.PartitionedStreamingEngine``.  Tolerance 0: counts,
hits, routing statistics, every snapshot leaf (rings, lane tables, node
stores, roots), manifests and enumerated match sets must be identical.
``lane_route_ref`` is held against the routing outputs of the reference's
jitted step on hand-set lane tables (ties in ``lane_last``, full tables,
NULL and raw ``EMPTY_LANE`` keys).
"""
import random
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Event as JEvent
from repro.core.partition import EMPTY_LANE, NULL_KEY_HASH
from repro.vector import PartitionedStreamingEngine as JPart
from repro.vector import VectorEngine as JVector
from repro.vector.multiquery import MultiQueryEngine as JMulti
from repro_torch.core.events import Event as TEvent
from repro_torch.core.partition import stable_key_hash
from repro_torch.kernels import ops
from repro_torch.kernels import window as t_window
from repro_torch.vector import MultiQueryEngine as TMulti
from repro_torch.vector import PartitionedStreamingEngine as TPart
from repro_torch.vector import PartitionStats
from repro_torch.vector import VectorEngine as TVector

from _route_cases import ROUTE_T, dup_tables, later_holders, route_cases

QTEXT = "SELECT * FROM S WHERE A ; B+ ; C WITHIN {} events"
QT_TIME = "SELECT * FROM S WHERE A ; B+ ; C WITHIN 7 seconds"


def events(raw, cls):
    """(type, attrs, timestamp) triples → Events of one package."""
    return [cls(t, dict(a), timestamp=ts) for t, a, ts in raw]


def make_raw(seed, T, alphabet="ABCX", keys=("u1", "u2", 7, 7.0, None),
             p_missing=0.05, timed=False):
    """Random interleaved stream: keys of mixed types, NULL values and
    events without the key attribute; ``timed`` adds monotone integer
    timestamps with equal runs."""
    rng = random.Random(seed)
    out, t = [], 0
    for _ in range(T):
        attrs = {} if rng.random() < p_missing else {"uid": rng.choice(keys)}
        t += rng.randint(0, 2)
        out.append((rng.choice(alphabet), attrs, float(t) if timed else None))
    return out


def engines(query, chunk, lanes, *, multi=False, mwe=None, **kw):
    """(reference, port) partitioned engines over the same query."""
    jv = (JMulti if multi else JVector)(query, use_pallas=False,
                                        max_window_events=mwe)
    tv = (TMulti if multi else TVector)(query, max_window_events=mwe,
                                        device="cpu")
    return (JPart(jv, ("uid",), chunk, lanes, **kw),
            TPart(tv, ("uid",), chunk, lanes, **kw))


def feed_both(jp, tp, raw):
    """Feed both chunk by chunk; counts, hits and stats agree after each.
    Returns the hits."""
    hits = []
    for lo in range(0, len(raw), tp.chunk_len):
        part = raw[lo:lo + tp.chunk_len]
        jc, jh = jp.feed(events(part, JEvent))
        tc, th = tp.feed(events(part, TEvent))
        assert tc.dtype == jc.dtype == np.int64 and tc.shape == jc.shape
        np.testing.assert_array_equal(tc, jc)
        assert th == jh
        assert asdict(tp.stats) == asdict(jp.stats)
        hits += th
    return hits


def assert_same_state(jp, tp):
    """Every snapshot leaf (dtype included) and the manifest agree."""
    js, ts = jp.snapshot(), tp.snapshot()
    assert ts["arrays"].keys() == js["arrays"].keys()
    for k, v in js["arrays"].items():
        v = np.asarray(v)
        assert ts["arrays"][k].dtype == v.dtype, k
        np.testing.assert_array_equal(ts["arrays"][k], v, err_msg=k)
    assert ts["meta"] == js["meta"]
    assert tp.num_active_lanes == jp.num_active_lanes
    assert tp.position == jp.position


def ce_sets(res):
    return {p: {(c.start, c.end, c.data) for c in ces}
            for p, ces in res.items()}


# ---------------------------------------------------------------------------
# the plain router ≡ the reference's jitted step
# ---------------------------------------------------------------------------

def j_route(jp, keys, lane_keys, lane_last, chunk_idx):
    """Routing outputs of the reference's step from a hand-set table."""
    st = jp._init_lane_state()
    st["lane_keys"] = jnp.asarray(np.asarray(lane_keys, np.uint32))
    st["lane_last"] = jnp.asarray(np.asarray(lane_last, np.int32))
    T = len(keys)
    _, new, info = jp._step(
        jnp.zeros((T, len(jp.encoder.attrs)), jnp.float32),
        jnp.asarray(np.asarray(keys, np.uint32)), st,
        jnp.asarray(chunk_idx, jnp.int32), jnp.arange(T, dtype=jnp.int32))
    return {k: np.asarray(v) for k, v in (
        ("lanes", info["lanes"]), ("routed", info["routed"]),
        ("nulls", info["nulls"]), ("spilled", info["spilled"]),
        ("evicted", info["evicted"]), ("fill", info["lane_fill"]),
        ("lane_keys", new["lane_keys"]), ("lane_last", new["lane_last"]))}


@pytest.mark.parametrize("L,evict,cap", [(1, "lru", ROUTE_T),
                                         (3, "lru", 3), (3, "none", ROUTE_T),
                                         (5, "lru", ROUTE_T),
                                         (5, "none", 4)])
def test_lane_route_ref_matches_reference_step(L, evict, cap):
    jp = JPart(JVector(QTEXT.format(5), use_pallas=False), ("uid",),
               ROUTE_T, L, lane_cap=cap, evict=evict)
    rng = random.Random(L * 7 + cap)
    for keys, table, last, chunk_idx in route_cases(rng, L):
        assert_route_matches(jp, keys, table, last, chunk_idx, cap, evict)


@pytest.mark.parametrize("L,T", [(3, 300), (7, 300), (64, 300)])
@pytest.mark.parametrize("evict", ["lru", "none"])
def test_lane_route_ref_matches_reference_on_duplicate_tables(L, T, evict):
    """Tables that hold a key in several lanes: when LRU evicts the lowest
    of them, the key's later events go to the next lane that still holds
    it, as the reference's argmax does."""
    cap = 8
    jp = JPart(JVector(QTEXT.format(5), use_pallas=False), ("uid",), T, L,
               lane_cap=cap, evict=evict)
    rng = np.random.default_rng(L)
    moved = 0
    for keys, table, last, chunk_idx in dup_tables(rng, L, T):
        got = assert_route_matches(jp, keys, table, last, chunk_idx, cap,
                                   evict)
        moved += later_holders(keys, table, got.lane)
    assert (moved > 0) == (evict == "lru")


def assert_route_matches(jp, keys, table, last, chunk_idx, cap, evict):
    """The plain router ≡ the reference's step on one hand-set table; its
    ranks count each lane's events in stream order."""
    L = len(table)
    want = j_route(jp, keys, table, last, chunk_idx)
    got = ops.lane_route(
        torch.tensor(keys, dtype=torch.int64),
        torch.tensor(table, dtype=torch.int64),
        torch.tensor(last, dtype=torch.int32), chunk_idx=chunk_idx,
        cap=cap, evict=evict)
    lane, rank = got.lane.numpy(), got.rank.numpy()
    routed = lane < L
    keep = routed & (rank < cap)
    np.testing.assert_array_equal(got.null.numpy(), want["nulls"])
    np.testing.assert_array_equal(routed, want["routed"])
    np.testing.assert_array_equal(np.where(keep, lane, L), want["lanes"])
    np.testing.assert_array_equal(routed & ~keep, want["spilled"])
    np.testing.assert_array_equal(got.fill.numpy(), want["fill"])
    np.testing.assert_array_equal(got.evicted.numpy(), want["evicted"])
    np.testing.assert_array_equal(
        got.lane_keys.numpy().view(np.uint32), want["lane_keys"])
    np.testing.assert_array_equal(got.lane_last.numpy(), want["lane_last"])
    # the kept events of a lane are its first cap, in stream order
    seen = {}
    for t in np.nonzero(keep)[0]:
        assert rank[t] == seen.get(lane[t], 0)
        seen[lane[t]] = rank[t] + 1
    assert (rank[~routed] == -1).all()
    return got


def test_lane_route_takes_any_key_dtype():
    keys = np.array([7, NULL_KEY_HASH, 0x80000000, 7], np.uint32)
    table = np.array([EMPTY_LANE, 0x80000000], np.uint32)
    outs = [ops.lane_route(k, t, torch.tensor([0, 0], dtype=torch.int32),
                           chunk_idx=1, cap=4)
            for k, t in ((torch.from_numpy(keys), torch.from_numpy(table)),
                         (torch.from_numpy(keys.view(np.int32)),
                          torch.from_numpy(table.view(np.int32))),
                         (torch.from_numpy(keys.astype(np.int64)),
                          torch.from_numpy(table.astype(np.int64))))]
    for o in outs:
        assert o.lane.tolist() == [0, 2, 1, 0]
        assert o.rank.tolist() == [0, -1, 0, 1]
        assert o.lane_keys.numpy().view(np.uint32).tolist() == \
            [7, 0x80000000]
    with pytest.raises(ValueError, match="evict"):
        ops.lane_route(torch.from_numpy(keys), torch.from_numpy(table),
                       torch.zeros(2, dtype=torch.int32), chunk_idx=0,
                       cap=4, evict="fifo")


# ---------------------------------------------------------------------------
# the engine ≡ the reference's (tests/test_partitioned_stream.py sweeps)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qtext", [
    "SELECT * FROM S WHERE A ; B ; C WITHIN 6 events",
    QTEXT.format(5),
    "SELECT * FROM S WHERE A ; (B OR C)+ ; A WITHIN 7 events",
])
@pytest.mark.parametrize("seed,chunk", [(1, 16), (2, 8)])
def test_randomized_stream_matches_reference(qtext, seed, chunk):
    raw = make_raw(seed, 64)
    jp, tp = engines(qtext, chunk, 8)
    feed_both(jp, tp, raw)
    assert tp.stats.dropped_null > 0
    assert_same_state(jp, tp)
    assert tp.compile_count == 0      # the plain route builds no kernel


def test_multi_attribute_key_matches_reference():
    rng = random.Random(11)
    raw = [(rng.choice("ABCX"), {"uid": rng.choice(["a", "b", None]),
                                 "region": rng.choice([1, 2])}, None)
           for _ in range(48)]
    jv = JVector(QTEXT.format(6), use_pallas=False)
    tv = TVector(QTEXT.format(6), device="cpu")
    jp = JPart(jv, ("uid", "region"), 16, 8)
    tp = tv.partitioned_streaming(("uid", "region"), 16, 8)
    assert isinstance(tp, TPart)
    feed_both(jp, tp, raw)
    assert_same_state(jp, tp)


def test_count_window_is_substream_local():
    raw = ([("A", {"uid": "u1"}, None)] + [("X", {"uid": "u2"}, None)] * 5
           + [("B", {"uid": "u1"}, None), ("X", {"uid": "u2"}, None)])
    jp, tp = engines("SELECT * FROM S WHERE A ; B WITHIN 1 events", 8, 4)
    assert feed_both(jp, tp, raw) == [6]
    assert_same_state(jp, tp)


def test_multiquery_matches_reference():
    queries = ["SELECT * FROM S WHERE A1 ; A2 WITHIN 5 events",
               "SELECT * FROM S WHERE A2 ; A1 WITHIN 5 events"]
    rng = random.Random(9)
    raw = [(rng.choice(["A1", "A2"]), {"uid": rng.choice(["x", "y", None])},
            None) for _ in range(32)]
    jp, tp = engines(queries, 16, 4, multi=True)
    feed_both(jp, tp, raw)
    assert tp.feed(events(raw[:16], TEvent))[0].shape == (16, 2)
    jp.feed(events(raw[:16], JEvent))
    assert_same_state(jp, tp)


@pytest.mark.parametrize("case", ["capacity", "table", "table_lru"])
def test_spills_match_reference(case):
    rng = random.Random(13 if case == "capacity" else 17)
    keys = ["a", "b"] if case == "capacity" else [f"u{i}" for i in range(6)]
    raw = [(rng.choice("ABCX"), {"uid": rng.choice(keys)}, None)
           for _ in range(64)]
    kw = {"capacity": dict(lane_cap=4),
          "table": dict(evict="none"),
          "table_lru": dict(evict="lru", lane_cap=5)}[case]
    jp, tp = engines(QTEXT.format(5), 16, 4 if case == "capacity" else 3,
                     **kw)
    feed_both(jp, tp, raw)
    st = tp.stats
    if case == "capacity":
        assert st.spilled_capacity > 0
    elif case == "table":
        assert st.spilled_table > 0 and st.evicted_lanes == 0
    else:
        assert st.evicted_lanes > 0
    assert st.routed + st.dropped_null + st.spilled_table + \
        st.spilled_capacity == st.events
    assert_same_state(jp, tp)


def test_lru_eviction_matches_reference():
    def mk(t, u):
        return (t, {"uid": u}, None)
    chunks = ([mk("A", "a")] + [mk("X", "b")] * 7,
              [mk("A", "c"), mk("B", "c")] + [mk("X", "c")] * 6,
              [mk("B", "a")] + [mk("X", "c")] * 7)
    jp, tp = engines("SELECT * FROM S WHERE A ; B WITHIN 3 events", 8, 2)
    for ch in chunks:
        feed_both(jp, tp, ch)
        assert_same_state(jp, tp)
    assert tp.stats.evicted_lanes == 2
    assert stable_key_hash(("a",)) in tp._lane_keys_np().tolist()


def test_evict_idle_matches_reference():
    rng = random.Random(23)
    raw = [(rng.choice("ABCX"), {"uid": rng.choice(["a", "b", "c"])}, None)
           for _ in range(32)]
    jp, tp = engines(QTEXT.format(5), 16, 8)
    feed_both(jp, tp, raw)
    for idle in (10, 0):
        assert tp.evict_idle(min_idle_chunks=idle) == \
            jp.evict_idle(min_idle_chunks=idle)
        assert_same_state(jp, tp)
    assert tp.num_active_lanes == 0
    feed_both(jp, tp, raw[:16])
    assert_same_state(jp, tp)
    # the boundary: a lane used in the latest chunk is 0 chunks idle
    jp, tp = engines(QTEXT.format(5), 4, 4)
    for u, want in (("a", 0), ("b", 1)):
        feed_both(jp, tp, [("A", {"uid": u}, None)] * 4)
        assert tp.evict_idle(1) == jp.evict_idle(1) == want
        assert_same_state(jp, tp)


def test_null_only_chunk_drops_everything():
    jp, tp = engines(QTEXT.format(5), 16, 4)
    assert feed_both(jp, tp, [("A", {}, None)] * 16) == []
    assert tp.stats.dropped_null == 16 and tp.num_active_lanes == 0
    assert_same_state(jp, tp)


def test_reset_rewinds_like_reference():
    raw = make_raw(31, 64)
    jp, tp = engines(QTEXT.format(6), 16, 8, arena_capacity=1 << 10)
    first = feed_both(jp, tp, raw)
    for e in (jp, tp):
        e.reset()
    assert tp.position == 0 and tp.num_active_lanes == 0
    assert tp.stats == PartitionStats()
    assert feed_both(jp, tp, raw) == first
    assert_same_state(jp, tp)


# ---------------------------------------------------------------------------
# the tECS arena at global positions
# ---------------------------------------------------------------------------

def test_arena_all_null_then_real_chunk():
    jp, tp = engines(QTEXT.format(5), 16, 4, arena_capacity=1 << 12)
    feed_both(jp, tp, [("A", {}, None)] * 16)
    assert tp.arena_snapshot().nodes_created == 0
    hits = feed_both(jp, tp, [(t, {"uid": "a"}, None)
                              for t in "ABCABCABCABCABCA"])
    assert hits
    assert ce_sets(tp.enumerate_hits(hits)) == \
        ce_sets(jp.enumerate_hits(hits))
    assert_same_state(jp, tp)


def test_arena_full_spill_chunk_keeps_arena():
    jp, tp = engines(QTEXT.format(5), 8, 4, evict="none",
                     arena_capacity=1 << 12)
    for us in ("abcd", "efgh"):
        feed_both(jp, tp, [("A", {"uid": u}, None) for u in us
                           for _ in range(2)])
        assert_same_state(jp, tp)
    assert tp.stats.spilled_table == 8


def test_arena_evict_idle_then_revival():
    jp, tp = engines(QTEXT.format(5), 8, 4, arena_capacity=1 << 12)
    h1 = feed_both(jp, tp, [(t, {"uid": "a"}, None) for t in "ABCABCAB"])
    assert tp.evict_idle(0) == jp.evict_idle(0) == 1
    h2 = feed_both(jp, tp, [(t, {"uid": "a"}, None) for t in "CABCABCA"])
    assert h1 and h2
    got = ce_sets(tp.enumerate_hits(h1 + h2))
    assert got == ce_sets(jp.enumerate_hits(h1 + h2))
    assert got[h2[0]] and all(c[0] >= 8 for c in got[h2[0]])
    assert_same_state(jp, tp)


def test_null_key_match_sets_match_reference():
    """tests/test_tecs_arena.py's NULL-key sweep: T=128, 8 lanes."""
    rng = random.Random(77)
    raw = [(rng.choice("ABCX"), {"uid": rng.choice(["x", "y", "z", None])},
            None) for _ in range(128)]
    jp, tp = engines("SELECT * FROM S WHERE A ; B ; C WITHIN 9 events", 32,
                     8, arena_capacity=1 << 12)
    hits = feed_both(jp, tp, raw)
    assert tp.stats.dropped_null > 0 and hits
    assert ce_sets(tp.enumerate_hits(hits)) == \
        ce_sets(jp.enumerate_hits(hits))
    p = hits[0]
    assert {(c.start, c.end, c.data) for c in tp.enumerate(p)} == \
        ce_sets(jp.enumerate_hits([p]))[p]
    with pytest.raises(TypeError, match="stream axis"):
        tp.enumerate((p, 0))
    assert_same_state(jp, tp)


@pytest.mark.parametrize("strategy,consume", [("MAX", False),
                                              ("LAST", True)])
def test_strategies_with_null_keys_match_reference(strategy, consume):
    """tests/test_selection_device.py's partitioned sweep."""
    text = (f"SELECT {strategy} * FROM S WHERE A ; B+ ; C WITHIN 6"
            + (" CONSUME BY ANY" if consume else ""))
    rng = random.Random(3)
    raw = []
    for _ in range(12):
        k = rng.choice([1, 2, None])
        raw.append((rng.choice("ABC"), {"uid": k} if k is not None else {},
                    None))
    jp, tp = engines(text, 6, 4, arena_capacity=256)
    hits = feed_both(jp, tp, raw)
    assert ce_sets(tp.enumerate_hits(hits)) == \
        ce_sets(jp.enumerate_hits(hits))
    assert_same_state(jp, tp)


# ---------------------------------------------------------------------------
# time windows (tests/test_time_window.py, tests/test_recovery.py)
# ---------------------------------------------------------------------------

def test_time_window_with_arena_matches_reference():
    raw = make_raw(51, 64, keys=("u1", "u2", 7, None), timed=True)
    jp, tp = engines("SELECT * FROM S WHERE A ; B+ ; C WITHIN 9 seconds",
                     16, 4, mwe=64, arena_capacity=1 << 12)
    hits = feed_both(jp, tp, raw)
    assert hits
    assert ce_sets(tp.enumerate_hits(hits)) == \
        ce_sets(jp.enumerate_hits(hits))
    assert_same_state(jp, tp)


def test_time_window_null_keys_without_clock():
    raw, t = [], 0
    for i in range(16):
        if i % 5 == 4:
            raw.append(("A", {}, None))
        else:
            t += 1
            raw.append(("AB"[i % 2], {"uid": "u1", "clk": t}, None))
    jp, tp = engines("SELECT * FROM S WHERE A ; B WITHIN 5 [clk]", 16, 2,
                     mwe=16)
    feed_both(jp, tp, raw)
    assert_same_state(jp, tp)


def test_time_window_audit_covers_routed_rows_only():
    jp, tp = engines(QT_TIME, 4, 2, mwe=8)
    raw = [("A", {"uid": "a"}, 1.0), ("B", {}, 0.5),
           ("C", {"uid": "a"}, 2.0), ("A", {"uid": "b"}, 2.0)]
    feed_both(jp, tp, raw)
    back = [("A", {"uid": "a"}, 1.5)] * 4
    with pytest.raises(ValueError, match="monotone"):
        tp.feed(events(back, TEvent))
    with pytest.raises(ValueError, match="event_ts"):
        tp.feed_keyed(np.zeros((4, 1), np.float32),
                      np.zeros(4, np.uint32))


def test_fallback_clock_matches_reference_across_checkpoint():
    raw = make_raw(33, 96, keys=("a", "b", None))
    jp, tp = engines(QT_TIME, 16, 8, mwe=16)
    feed_both(jp, tp, raw[:48])
    snap = tp.snapshot()
    assert any(n > 0 for n in snap["meta"]["fallback_clock"].values())
    assert snap["meta"]["fallback_clock"] == \
        jp.snapshot()["meta"]["fallback_clock"]
    _, fresh = engines(QT_TIME, 16, 8, mwe=16)
    fresh.restore(snap)
    feed_both(jp, fresh, raw[48:])
    assert_same_state(jp, fresh)


def test_strict_overflow_stats_and_manifest():
    dense = [("A", {"uid": "a"}, i * 0.1) for i in range(16)]
    jp, tp = engines(QT_TIME, 16, 4, mwe=8, strict_overflow=True)
    with pytest.raises(t_window.WindowOverflowError) as ei:
        tp.feed(events(dense, TEvent))
    with pytest.raises(Exception):
        jp.feed(events(dense, JEvent))
    assert tp.stats.overflow_lanes == len(ei.value.lanes) == 1
    assert asdict(tp.stats) == asdict(jp.stats)
    assert tp.manifest()["window_overflow"] == ei.value.lanes == \
        jp.manifest()["window_overflow"]
    assert_same_state(jp, tp)


# ---------------------------------------------------------------------------
# snapshots across packages and elastic lanes (tests/test_recovery.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["count_arena", "time"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_crosses_packages(kind, direction):
    if kind == "time":
        raw = make_raw(41, 64, keys=("a", "b", None), timed=True)
        make = lambda: engines(QT_TIME, 16, 4, mwe=32)      # noqa: E731
    else:
        raw = make_raw(41, 64)
        make = lambda: engines(QTEXT.format(5), 16, 4,      # noqa: E731
                               arena_capacity=1 << 12)
    jp, tp = make()
    src = jp if direction == "jax_to_port" else tp
    for lo in range(0, 32, 16):
        src.feed(events(raw[lo:lo + 16],
                        JEvent if src is jp else TEvent))
    src.quarantine([2, 0])
    (jp if src is tp else tp).restore(src.snapshot())
    assert tp.quarantined_lanes == jp.quarantined_lanes == (0, 2)
    assert_same_state(jp, tp)
    hits = feed_both(jp, tp, raw[32:])
    assert_same_state(jp, tp)
    if kind == "count_arena":
        assert ce_sets(tp.enumerate_hits(hits)) == \
            ce_sets(jp.enumerate_hits(hits))


def test_rescale_8_16_8_matches_reference():
    raw = make_raw(21, 128, keys=("u1", "u2", 7, None))
    jp, tp = engines(QTEXT.format(5), 16, 8, arena_capacity=1 << 12)
    feed_both(jp, tp, raw[:48])
    j16, t16 = engines(QTEXT.format(5), 16, 16, arena_capacity=1 << 12)
    j16.restore(jp.snapshot())
    t16.restore(tp.snapshot())
    assert_same_state(j16, t16)
    feed_both(j16, t16, raw[48:96])
    for e in (j16, t16):
        e.restore(e.snapshot(), n_lanes=8)
    assert t16.num_lanes == 8
    assert_same_state(j16, t16)
    hits = feed_both(j16, t16, raw[96:])
    assert_same_state(j16, t16)
    assert ce_sets(t16.enumerate_hits(hits)) == \
        ce_sets(j16.enumerate_hits(hits))


def test_rescale_shrink_evicts_lru_lanes():
    jp, tp = engines(QTEXT.format(5), 4, 8)
    for u in "abcd":
        feed_both(jp, tp, [("A", {"uid": u}, None)] * 4)
    js, ts = engines(QTEXT.format(5), 4, 2)
    js.restore(jp.snapshot())
    ts.restore(jp.snapshot())           # the reference's snapshot
    assert ts.num_active_lanes == 2
    assert ts.stats.evicted_lanes == tp.stats.evicted_lanes + 2
    kept = set(ts._lane_keys_np().tolist())
    assert {stable_key_hash(("c",)), stable_key_hash(("d",))} <= kept
    assert_same_state(js, ts)
    feed_both(js, ts, [("A", {"uid": "d"}, None)] * 4)
    assert_same_state(js, ts)


def test_rescale_refuses_a_foreign_lane_table():
    jp, tp = engines(QTEXT.format(5), 4, 4)
    snap = tp.snapshot()
    snap["arrays"]["state/lane_keys"] = \
        snap["arrays"]["state/lane_keys"].astype(np.int64)
    snap["meta"] = dict(snap["meta"], num_lanes=4)
    _, small = engines(QTEXT.format(5), 4, 2)
    with pytest.raises(ValueError, match="lane_keys"):
        small.restore(snap)


# ---------------------------------------------------------------------------
# the rest of the contract
# ---------------------------------------------------------------------------

def test_ragged_and_unkeyed_feeds_rejected():
    tp = TPart(TVector(QTEXT.format(5), device="cpu"), ("uid",), 16, 4)
    with pytest.raises(ValueError, match="chunk_len"):
        tp.feed(events(make_raw(0, 5), TEvent))
    with pytest.raises(ValueError, match="chunk_len"):
        tp.feed_keyed(np.zeros((16, 1), np.float32), np.zeros(8, np.uint32))
    with pytest.raises(TypeError, match="routes by key"):
        tp.feed_attrs(torch.zeros(16, 4, 1))
    with pytest.raises(ValueError, match="evict"):
        TPart(TVector(QTEXT.format(5), device="cpu"), ("uid",), 16, 4,
              evict="fifo")


def test_hash_collision_detected(monkeypatch):
    import repro_torch.vector.encoder as enc
    monkeypatch.setattr(enc, "stable_key_hash",
                        lambda k: 7 if k is not None else NULL_KEY_HASH)
    tp = TPart(TVector(QTEXT.format(5), device="cpu"), ("uid",), 4, 4)
    raw = [("A", {"uid": "a"}, None), ("B", {"uid": "b"}, None),
           ("C", {"uid": "a"}, None), ("X", {"uid": "a"}, None)]
    with pytest.raises(ValueError, match="collision"):
        tp.feed(events(raw, TEvent))


def test_feed_keyed_positions_label_hits():
    """The sharded caller's entry: rows carry their own global positions."""
    raw = make_raw(41, 32)
    jp, tp = engines(QTEXT.format(5), 16, 8, arena_capacity=1 << 12)
    for lo in (16, 0):       # out of stream order, positions given
        part = raw[lo:lo + 16]
        attrs, keys = tp.encoder.encode_stream_with_keys(
            events(part, TEvent), ("uid",))
        pos = np.arange(lo, lo + 16)[::-1].copy()
        got = tp.feed_keyed(attrs[::-1].copy(), keys[::-1].copy(),
                            positions=pos)
        want = jp.feed_keyed(jnp.asarray(attrs[::-1].copy()),
                             jnp.asarray(keys[::-1].copy()), positions=pos)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == sorted(got[1])
    assert_same_state(jp, tp)


def test_regrow_restore_matches_reference():
    """A time window's ring regrows through restore(max_window_events=)
    with lane evictions (6 keys, 4 lanes) and the arena on; the mirror
    refetches from row 0."""
    rng = random.Random(7)
    raw = [(rng.choice("ABC"), {"t": float(i) * 5.0, "uid": rng.randrange(6)},
            None) for i in range(128)]
    jp, tp = engines("SELECT * FROM S WHERE A ; B+ ; C WITHIN 50 [t]", 16, 4,
                     mwe=8, arena_capacity=1 << 12)
    feed_both(jp, tp, raw[:64])
    for e in (jp, tp):
        e.restore(e.snapshot(), max_window_events=64)
    assert tp.window.ring == jp.window.ring > 8
    assert tp._arena_mirror.fetched == 0
    assert_same_state(jp, tp)
    hits = feed_both(jp, tp, raw[64:])
    assert tp.stats.evicted_lanes > 0
    assert_same_state(jp, tp)
    live = [p for p in hits if p in tp._roots]
    assert ce_sets(tp.enumerate_hits(live)) == \
        ce_sets(jp.enumerate_hits(live))


def test_repack_restore_matches_reference():
    """PARTITION BY lanes and a packing change in one restore (qa
    survives, qb leaves, qd arrives), as tests/test_fleet.py runs it."""
    from repro.vector.multiquery import build_packing as j_pack
    from repro_torch.vector import build_packing as t_pack
    q_a = ("SELECT * FROM S WHERE (E AS a; E AS b) "
           "FILTER a[x > 6] AND b[x < 3] WITHIN 8 events")
    q_b = ("SELECT * FROM S WHERE (E AS a; E AS b) "
           "FILTER a[y > 7] AND b[y > 7] WITHIN 8 events")
    q_d = ("SELECT * FROM S WHERE (E AS a; E AS b; E AS c) "
           "FILTER a[x > 4] AND b[y > 4] AND c[x < 4] WITHIN 8 events")
    rng = random.Random(13)
    raw = [("E", {"x": float(rng.randrange(10)), "y": float(rng.randrange(10)),
                  "uid": rng.choice(["u1", "u2", "u3"])}, None)
           for _ in range(64)]

    def mk(queries, qids):
        je = JMulti.from_packing(j_pack(queries, qids=qids),
                                 use_pallas=False, impl="ref")
        te = TMulti.from_packing(t_pack(queries, qids=qids), device="cpu")
        return JPart(je, ("uid",), 16, 4), TPart(te, ("uid",), 16, 4)
    j2, t2 = mk([q_a, q_b], ("qa", "qb"))
    feed_both(j2, t2, raw[:32])
    j3, t3 = mk([q_a, q_d], ("qa", "qd"))
    j3.restore(j2.snapshot(), migrate_packing=True)
    t3.restore(j2.snapshot(), migrate_packing=True)
    assert_same_state(j3, t3)
    feed_both(j3, t3, raw[32:])
    assert_same_state(j3, t3)


def test_restore_refuses_another_key_set():
    jp, tp = engines(QTEXT.format(5), 8, 4)
    feed_both(jp, tp, make_raw(5, 8))
    other = TPart(TVector(QTEXT.format(5), device="cpu"), ("region",), 8, 4)
    with pytest.raises(ValueError, match="key_attrs"):
        other.restore(jp.snapshot())


def test_snapshot_is_a_copy():
    """A snapshot keeps its values while the engine feeds on (the uint32
    lane table included)."""
    _, tp = engines(QTEXT.format(5), 8, 4, arena_capacity=1 << 10)
    tp.feed(events(make_raw(3, 8), TEvent))
    snap = tp.snapshot()
    kept = {k: v.copy() for k, v in snap["arrays"].items()}
    tp.feed(events([(t, {"uid": u}, None) for t, u in
                    zip("ABCABCAB", "pqrspqrs")], TEvent))
    assert not np.array_equal(tp.snapshot()["arrays"]["state/lane_keys"],
                              kept["state/lane_keys"])
    for k, v in kept.items():
        np.testing.assert_array_equal(snap["arrays"][k], v, err_msg=k)
