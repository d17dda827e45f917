"""Enumeration through the port's device tECS arena against the reference
package's, on the CPU (tolerance 0: counts, node stores, roots and the
enumerated complex events must be identical).

The streaming engines of both packages run the same events (from the same
seeds) over 3 chunks; the reference runs once per query and is shared by
the tests of this file.  Enumerated sets are also held against the port's
host ``Engine`` (Algorithm 1, with the query's selection strategy)."""
import numpy as np
import pytest

from repro.data.streams import StreamSpec as JSpec
from repro.data.streams import random_stream as j_random
from repro.data.streams import stock_stream as j_stock
from repro.vector import StreamingVectorEngine as JStreaming
from repro.vector import VectorEngine as JVector
from repro.vector.streaming import migrate_ring_arrays as j_migrate
from repro_torch.core import compile_query
from repro_torch.core.engine import Engine
from repro_torch.core.selection import apply_strategy
from repro_torch.data import StreamSpec as TSpec
from repro_torch.data import random_stream as t_random
from repro_torch.data import stock_stream as t_stock
from repro_torch.vector import ArenaOverflow as TOverflow
from repro_torch.vector import StreamingVectorEngine as TStreaming
from repro_torch.vector import VectorEngine as TVector
from repro_torch.vector import tecs_arena as tta
from repro_torch.vector.streaming import migrate_ring_arrays as t_migrate

STOCK_Q1 = """SELECT * FROM S
    WHERE SELL AS msft ; BUY AS oracle ; BUY AS csco ; SELL AS amat
    FILTER msft[name = 'MSFT'] AND oracle[name = 'ORCL'] AND
    csco[name = 'CSCO'] AND amat[name = 'AMAT']
    WITHIN 30000 [stock_time]"""
TYPES = ["A1", "A2", "A3"]
KINDS = {
    "count": ("SELECT * FROM S WHERE A1 ; A2+ ; A3 WITHIN 11 events", None),
    "last": ("SELECT LAST * FROM S WHERE A1 ; A2 WITHIN 13 events", None),
    "consume": ("SELECT * FROM S WHERE A1 ; A2 ; A3 WITHIN 9 events "
                "CONSUME BY ANY", None),
    "time": (STOCK_Q1, 48),
}
B, CHUNK, N_CHUNKS, CAP = 3, 12, 3, 1 << 11
T = CHUNK * N_CHUNKS


def streams(kind, seed=17, rate=1.0):
    """Equal event streams for both packages, from the same seeds."""
    if kind == "time":
        names = ["MSFT", "ORCL", "CSCO", "AMAT"]   # the query's four names
        make = [lambda s: j_stock(T, seed=s, events_per_sec=rate,
                                  names=names),
                lambda s: t_stock(T, seed=s, events_per_sec=rate,
                                  names=names)]
    else:
        make = [lambda s: j_random(JSpec(TYPES, seed=s), T),
                lambda s: t_random(TSpec(TYPES, seed=s), T)]
    return [[m(seed + b) for b in range(B)] for m in make]


def chunk(ss, i):
    return [s[i * CHUNK:(i + 1) * CHUNK] for s in ss]


def ceset(ces):
    return {(int(c.start), int(c.end), tuple(map(int, c.data)))
            for c in ces}


def port_engine(kind, **kw):
    query, mwe = KINDS[kind]
    kw.setdefault("arena_capacity", CAP)
    return TStreaming(TVector(query, max_window_events=mwe, device="cpu"),
                      CHUNK, B, **kw)


_REF = {}


def reference(kind):
    """The reference package's streaming run of ``kind`` (compiled once
    per file): per-chunk counts, hits and snapshots, and the enumerated
    sets of every hit."""
    if kind not in _REF:
        query, mwe = KINDS[kind]
        js = JStreaming(JVector(query, max_window_events=mwe,
                                use_pallas=False), CHUNK, B,
                        arena_capacity=CAP)
        j_ss, t_ss = streams(kind)
        per_chunk, hits = [], []
        for i in range(N_CHUNKS):
            counts, h = js.feed(chunk(j_ss, i))
            per_chunk.append((counts, h, js.snapshot()))
            hits += h
        sets = {k: ceset(v) for k, v in js.enumerate_hits(hits).items()}
        _REF[kind] = dict(engine=js, chunks=per_chunk, hits=hits,
                          sets=sets, j_ss=j_ss, t_ss=t_ss)
    return _REF[kind]


def host_sets(kind, t_ss):
    """(position, lane) → complex events of the port's host Engine."""
    cq = compile_query(KINDS[kind][0])
    out = {}
    for b, s in enumerate(t_ss):
        eng = Engine(cq.cea, window=cq.query.window,
                     consume_on_match=cq.query.consume_on_match)
        for p, ev in enumerate(s):
            ces = apply_strategy(cq.query.strategy, eng.process(ev))
            if ces:
                out[(p, b)] = ceset(ces)
    return out


def assert_snapshots_equal(ja, ta, what=""):
    assert ja.keys() == ta.keys(), (what, sorted(ja), sorted(ta))
    for k in ja:
        x, y = np.asarray(ja[k]), np.asarray(ta[k])
        assert x.dtype == y.dtype, (what, k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}:{k}")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_streaming_arena_matches_reference(kind):
    ref = reference(kind)
    ts = port_engine(kind)
    assert ts.manifest()["arena_capacity"] == CAP
    hits = []
    for i, (jcounts, jhits, jsnap) in enumerate(ref["chunks"]):
        counts, h = ts.feed(chunk(ref["t_ss"], i))
        np.testing.assert_array_equal(jcounts, counts)
        assert h == jhits
        assert_snapshots_equal(jsnap["arrays"], ts.snapshot()["arrays"],
                               f"chunk {i}")
        hits += h
    assert hits, "the run has hits to enumerate"
    got = {k: ceset(v) for k, v in ts.enumerate_hits(hits).items()}
    assert got == ref["sets"]
    assert got == host_sets(kind, ref["t_ss"])
    assert {k: ceset(v) for k, v in
            ts.enumerate_hits(hits, oracle=True).items()} == got
    snap = ts.arena_snapshot()
    for b in range(B):
        tta.check_invariants(snap, b)
    assert ts.compile_count == 0   # the plain route builds no kernel
    p, b = hits[-1]
    assert ceset(ts.enumerate(p, b)) == got[(p, b)]


def test_fold_arena_impl_matches_reference():
    ref = reference("count")
    ts = port_engine("count", arena_impl="fold")
    for i in range(N_CHUNKS):
        ts.feed(chunk(ref["t_ss"], i))
    jsnap = ref["chunks"][-1][2]["arrays"]
    tsnap = ts.snapshot()["arrays"]
    sink = CAP                     # the fold's sink slot is write-only
    for k in jsnap:
        x, y = np.asarray(jsnap[k]), tsnap[k]
        if k.startswith("state/arena/") and x.ndim == 2 and k != \
                "state/arena/cell":
            x, y = x[:, :sink], y[:, :sink]
        np.testing.assert_array_equal(x, y, err_msg=k)
    got = {k: ceset(v) for k, v in ts.enumerate_hits(ref["hits"]).items()}
    assert got == ref["sets"]


@pytest.mark.parametrize("kind", ["count", "time"])
def test_snapshot_reference_to_port(kind):
    ref = reference(kind)
    ts = port_engine(kind)
    ts.restore(ref["chunks"][0][2])
    for i in range(1, N_CHUNKS):
        counts, h = ts.feed(chunk(ref["t_ss"], i))
        np.testing.assert_array_equal(ref["chunks"][i][0], counts)
    assert_snapshots_equal(ref["chunks"][-1][2]["arrays"],
                           ts.snapshot()["arrays"])
    got = {k: ceset(v) for k, v in ts.enumerate_hits(ref["hits"]).items()}
    assert got == ref["sets"]


@pytest.mark.parametrize("kind", ["count", "time"])
def test_snapshot_port_to_reference(kind):
    ref = reference(kind)
    ts = port_engine(kind)
    ts.feed(chunk(ref["t_ss"], 0))
    js = ref["engine"]
    js.restore(ts.snapshot())
    for i in range(1, N_CHUNKS):
        jc, jh = js.feed(chunk(ref["j_ss"], i))
        tc, th = ts.feed(chunk(ref["t_ss"], i))
        np.testing.assert_array_equal(jc, tc)
        assert jh == th
    assert_snapshots_equal(js.snapshot()["arrays"], ts.snapshot()["arrays"])
    want = {k: ceset(v) for k, v in js.enumerate_hits(ref["hits"]).items()}
    assert want == ref["sets"]


def test_ring_regrow_restore_pads_arena_cells():
    """A time window's ring grows while restoring: the arena cell table
    moves slot by slot like the count rings, its new slots hold NULL, and
    the regrown engine enumerates what the host engine finds."""
    _, t_ss = streams("time", seed=41, rate=2.0)
    ts = TStreaming(TVector(STOCK_Q1, max_window_events=16, device="cpu"),
                    CHUNK, B, arena_capacity=CAP)
    hits = ts.feed(chunk(t_ss, 0))[1]
    snap = ts.snapshot()
    frame = np.full(B, int(snap["meta"]["pos"]), np.int64)
    want = j_migrate(snap["arrays"], 16, 40, frame)
    got = t_migrate(snap["arrays"], 16, 40, frame)
    assert_snapshots_equal(want, got)
    cell = got["state/arena/cell"]
    assert cell.shape[1] == 40 and (cell == tta.NULL).sum() >= B * 24 * \
        cell.shape[2]
    ts.restore(snap, max_window_events=40)
    assert ts.window.ring == 40
    np.testing.assert_array_equal(ts.state["arena"]["cell"].numpy(), cell)
    for i in range(1, N_CHUNKS):
        hits += ts.feed(chunk(t_ss, i))[1]
    assert not ts.window_overflow.any()
    got_sets = {k: ceset(v) for k, v in ts.enumerate_hits(hits).items()}
    want_sets = host_sets("time", t_ss)
    assert got_sets == {k: v for k, v in want_sets.items()
                        if k in got_sets}
    assert set(want_sets) <= set(got_sets)


def test_run_enumerate_matches_reference():
    query = KINDS["count"][0]
    j_ss, t_ss = streams("count", seed=5)
    jc, jm = JVector(query, use_pallas=False).run_enumerate(j_ss)
    tc, tm = TVector(query, device="cpu").run_enumerate(t_ss)
    np.testing.assert_array_equal(jc, tc)
    assert tc.dtype == np.int64
    assert ({k: ceset(v) for k, v in jm.items()}
            == {k: ceset(v) for k, v in tm.items()})
    assert {(p, b): v for (p, b), v in
            ((k, ceset(v)) for k, v in tm.items())} == host_sets("count",
                                                                t_ss)
    # native LAST: the latest-start group, as the host's LAST filter
    _, t_ss = streams("last", seed=5)
    _, lm = TVector(KINDS["last"][0], device="cpu").run_enumerate(t_ss)
    assert {k: ceset(v) for k, v in lm.items()} == host_sets("last", t_ss)
    with pytest.raises(ValueError, match="post-filter"):
        TVector(KINDS["last"][0], device="cpu").run_enumerate(
            t_ss, strategy="MAX")


def test_clear_roots_and_reset():
    ref = reference("count")
    ts = port_engine("count")
    buf = ts.state["arena"]["kind"]
    hits = []
    for i in range(N_CHUNKS):
        hits += ts.feed(chunk(ref["t_ss"], i))[1]
    first = {k: ceset(v) for k, v in ts.enumerate_hits(hits).items()}
    cut = hits[len(hits) // 2][0]
    n_before = sum(1 for p, _ in hits if p < cut)
    assert ts.clear_roots(before=cut) == n_before
    after = ts.enumerate_hits(hits)
    for (p, b), ces in after.items():
        assert ceset(ces) == (set() if p < cut else first[(p, b)])
    assert ts.manifest()["num_roots"] == len(hits) - n_before
    ts.reset()
    assert ts.position == 0 and ts.clear_roots() == 0
    assert int(ts.state["arena"]["ptr"].sum()) == 0
    assert ts.state["arena"]["kind"] is buf      # buffers are kept
    for i in range(N_CHUNKS):
        counts, _ = ts.feed(chunk(ref["t_ss"], i))
        np.testing.assert_array_equal(ref["chunks"][i][0], counts)
    assert {k: ceset(v) for k, v in ts.enumerate_hits(hits).items()} \
        == first == ref["sets"]


def test_arena_overflow_keeps_counts_and_refuses_enumeration():
    ref = reference("count")
    ts = port_engine("count", arena_capacity=24)
    for i in range(N_CHUNKS):
        counts, _ = ts.feed(chunk(ref["t_ss"], i))
        np.testing.assert_array_equal(ref["chunks"][i][0], counts)
    ovf = ts.state["arena"]["ovf"].numpy()
    assert ovf.any()
    lost = [h for h in ref["hits"] if ovf[h[1]]]
    assert lost, "a lane with hits overflowed"
    with pytest.raises(TOverflow):
        ts.enumerate_hits(lost[:1])
