"""The port's ``QueryFleet`` against the reference package's, on the CPU
route: the churn scripts of ``tests/test_fleet.py`` and more.

Every script runs through both fleets at once (:class:`Twin`); after every
add, remove and feed the two must agree exactly: counts and hits, live
qids, the compile-cache counters (``compile_count``,
``distinct_geometries``, ``cache_hits``), the cost report (geometry tuples
included), the manifest as JSON and every snapshot leaf.  Snapshots restore
across the packages both ways mid-churn, a bad query rolls back with the
same exception type, the arena's enumerated sets agree after repacks, a
kill -9 mid-churn resumes to the uninterrupted run's matches, and the
``StreamService`` over a batch-1 fleet writes the reference's
``matches.log`` byte for byte.  Tolerance 0 everywhere.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.runtime as jrt
from _hyp import given, settings, st
from repro.core.events import Event as JEvent
from repro.runtime.fleet import QueryFleet as JFleet
from repro_torch.core.events import Event as TEvent
from repro_torch.kernels.build import LIBRARY
from repro_torch.runtime import (CompileCache, QueryFleet, StreamService,
                                 cumulative_matches)
from repro_torch.runtime.service import _make_adapter
from repro_torch.vector import MultiQueryEngine, StreamingVectorEngine
from test_fleet import POOL, Q_A, Q_B, Q_C, Q_D, Q_T, B, T
from test_torch_service import make_raws, read

# 13 and 14 live predicates in one bucket: padded to 16 bits, and six
# attributes (type, x, y, z, u, v) padded to eight columns
Q_W1 = ("SELECT * FROM S WHERE (E AS a; E AS b; E AS c; E AS d) FILTER "
        "a[x > 1] AND a[y < 8] AND b[x > 3] AND b[z < 6] AND c[u > 2] AND "
        "c[v < 7] AND d[x < 5] AND d[y > 4] WITHIN 8 events")
Q_W2 = ("SELECT * FROM S WHERE (E AS a; E AS b) FILTER a[z > 6] AND "
        "a[u < 3] AND b[v > 5] AND b[y > 2] AND a[x = 4] WITHIN 8 events")
# the Fig. 8 shape: four queries pack to 28 states (the 32-state build), a
# fifth to 35 (padded to 64, the wide build)
FIG8 = "SELECT * FROM S WHERE {} WITHIN 20 events"
FIG8_SEQS = ("A1 ; A2 ; A3", "B1 ; B2 ; B3", "B4 ; B5 ; B6", "A1 ; B5 ; A3",
             "A2 ; B1 ; A3")
FIG8_TYPES = ["A1", "A2", "A3"] + [f"B{i}" for i in range(1, 7)]
# mixed selection strategies and CONSUME in one bucket (semantic operands)
MIXED = ["SELECT * FROM S WHERE A ; B+ ; C WITHIN 6",
         "SELECT MAX * FROM S WHERE A ; B+ ; C WITHIN 6",
         "SELECT LAST * FROM S WHERE A ; B+ ; C WITHIN 6",
         "SELECT NEXT * FROM S WHERE A ; B+ ; C WITHIN 6 CONSUME BY ANY"]
# a query whose predicates push Q_W1's bucket past the 14 bits a query set
# may compile to: its add fails in the repack and rolls back
Q_TOO_WIDE = ("SELECT * FROM S WHERE (E AS a; E AS b) FILTER a[x > 7] AND "
              "a[y > 1] AND b[z > 2] AND b[u > 4] AND a[v > 3] WITHIN 8 "
              "events")
QT_SERVICE = "SELECT * FROM S WHERE A ; B+ ; C WITHIN 50 [t]"


def mk_chunks(seed, n, *, types=("E",), attrs=("x", "y"), missing=0.0,
              chunk_len=T, batch=B):
    """``n`` chunks of ``batch`` streams × ``chunk_len`` events for both
    packages: ``(repro chunks, port chunks)``.  Attribute values are
    integers 0-9 (missing with probability ``missing``: NaN columns);
    timestamps are stream positions."""
    rng = np.random.default_rng(seed)
    jc, tc = [], []
    for c in range(n):
        js, ts = [], []
        for _ in range(batch):
            je, te = [], []
            for t in range(chunk_len):
                ty = str(types[int(rng.integers(0, len(types)))])
                vals = {a: float(rng.integers(0, 10)) for a in attrs
                        if rng.random() >= missing}
                ts_ = float(c * chunk_len + t)
                je.append(JEvent(ty, dict(vals), timestamp=ts_))
                te.append(TEvent(ty, dict(vals), timestamp=ts_))
            js.append(je)
            ts.append(te)
        jc.append(js)
        tc.append(ts)
    return jc, tc


def leaves_equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for name in a:
        x, y = np.asarray(a[name]), np.asarray(b[name])
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def assert_same_fleets(j, t, *, leaves: bool = True,
                       counters: bool = True) -> None:
    """Every observable of the two fleets equal (``counters``: the cache
    counters too, which a restored fleet starts afresh)."""
    assert t.live_qids == j.live_qids
    assert t.position == j.position
    if counters:
        assert (t.compile_count, t.distinct_geometries, t.cache_hits) == \
            (j.compile_count, j.distinct_geometries, j.cache_hits)
    assert t.cost_report() == j.cost_report()
    assert json.dumps(t.manifest()) == json.dumps(j.manifest())
    if leaves:
        leaves_equal(t.snapshot()["arrays"], j.snapshot()["arrays"])


class Twin:
    """One fleet of each package driven by the same operations, compared
    after every one of them."""

    def __init__(self, leaves: bool = True, **kw):
        self.j = JFleet(**kw)
        self.t = QueryFleet(device="cpu", **kw)
        self.leaves = leaves

    def check(self):
        assert_same_fleets(self.j, self.t, leaves=self.leaves)

    def add(self, text, qid=None):
        a = self.j.add_query(text, qid)
        assert self.t.add_query(text, qid) == a
        self.check()
        return a

    def remove(self, qid):
        self.j.remove_query(qid)
        self.t.remove_query(qid)
        self.check()

    def feed(self, jchunk, tchunk):
        cj, hj = self.j.feed(jchunk)
        ct, ht = self.t.feed(tchunk)
        assert ct.dtype == cj.dtype and ct.shape == cj.shape
        np.testing.assert_array_equal(ct, cj)
        assert ht == hj
        self.check()
        return ct, ht


def oracle_counts(query, tchunks, **kw):
    """The port's static engine over ``tchunks`` from empty state."""
    eng = MultiQueryEngine([query], device="cpu", **kw)
    se = StreamingVectorEngine(eng, len(tchunks[0][0]), len(tchunks[0]))
    return [se.feed(c)[0][:, :, 0] for c in tchunks]


# ---------------------------------------------------------------------------
# churn scripts, both packages in lockstep
# ---------------------------------------------------------------------------

def script_single_bucket(tw, jc, tc):
    tw.add(Q_A)
    tw.add(Q_B)
    for i in range(4):
        tw.feed(jc[i], tc[i])
    assert tw.t.num_buckets == 1


def script_mixed_windows(tw, jc, tc):
    qa, qc, qt = tw.add(Q_A), tw.add(Q_C), tw.add(Q_T)
    assert tw.t.num_buckets == 3
    assert tw.t.bucket_of(qt)[0] == "time"
    for i in range(4):
        counts, _ = tw.feed(jc[i], tc[i])
        col = tw.t.live_qids.index
        np.testing.assert_array_equal(counts[:, :, col(qt)],
                                      counts[:, :, col(qa)])


def script_churn_migration(tw, jc, tc):
    qa = tw.add(Q_A)
    got = [tw.feed(jc[0], tc[0])[0]]
    qb = tw.add(Q_B)
    got += [tw.feed(jc[i], tc[i])[0] for i in (1, 2)]
    tw.remove(qb)
    got.append(tw.feed(jc[3], tc[3])[0])
    tw.add(Q_B)
    got += [tw.feed(jc[i], tc[i])[0] for i in (4, 5)]
    # the survivor equals a fresh port engine over the whole stream
    for g, w in zip(got, oracle_counts(Q_A, tc[:6])):
        np.testing.assert_array_equal(g[:, :, tw.t.live_qids.index(qa)], w)


def script_wide_bits(tw, jc, tc):
    q1 = tw.add(Q_W1)
    tw.feed(jc[0], tc[0])
    tw.add(Q_W2)
    eng = tw.t._find_bucket(q1).engine
    pk = eng.engine.packing
    assert (pk.num_bits, pk.padded_bits) == (14, 16)
    assert eng.geometry[4] == 8              # six attributes, eight slots
    assert len(eng._operands["specs"]) == 16
    for i in (1, 2, 3):
        tw.feed(jc[i], tc[i])


def script_state_bucket_crossing(tw, jc, tc):
    qids = [tw.add(FIG8.format(s)) for s in FIG8_SEQS[:4]]
    eng = tw.t._find_bucket(qids[0]).engine
    assert (eng.engine.packing.num_states, eng.geometry[0]) == (28, 32)
    assert eng._entry.state_bucket == 32
    tw.feed(jc[0], tc[0])
    q5 = tw.add(FIG8.format(FIG8_SEQS[4]))
    eng = tw.t._find_bucket(q5).engine
    assert (eng.engine.packing.num_states, eng.geometry[0]) == (35, 64)
    assert eng._entry.state_bucket == 512           # the wide build
    tw.feed(jc[1], tc[1])
    tw.remove(q5)
    assert tw.t._find_bucket(qids[0]).engine._entry.state_bucket == 32
    tw.feed(jc[2], tc[2])
    tw.remove(qids[1])
    tw.add(FIG8.format(FIG8_SEQS[1]), qid="again")
    tw.feed(jc[3], tc[3])


def script_semantics(tw, jc, tc):
    qids = [tw.add(q) for q in MIXED[:2]]
    tw.feed(jc[0], tc[0])
    geo = tw.t._find_bucket(qids[0]).engine.geometry
    assert geo[-2:] == (False, False)
    qids += [tw.add(q) for q in MIXED[2:]]
    geo = tw.t._find_bucket(qids[0]).engine.geometry
    assert geo[-2:] == (True, True)          # LAST and CONSUME operands
    for i in (1, 2):
        tw.feed(jc[i], tc[i])
    tw.remove(qids[3])
    tw.feed(jc[3], tc[3])


SCRIPTS = {
    "single_bucket": (script_single_bucket, {}, dict(seed=0)),
    "mixed_windows": (script_mixed_windows, {}, dict(seed=1)),
    "churn_migration": (script_churn_migration, {}, dict(seed=3)),
    "wide_bits": (script_wide_bits, {},
                  dict(seed=12, attrs=("x", "y", "z", "u", "v"),
                       missing=0.1)),
    "state_bucket_crossing": (script_state_bucket_crossing, {},
                              dict(seed=13, types=FIG8_TYPES, attrs=())),
    "semantics": (script_semantics, dict(epsilon=6),
                  dict(seed=14, types=("A", "B", "C"), attrs=())),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_fleet_script_matches_reference(name):
    script, fleet_kw, data_kw = SCRIPTS[name]
    jc, tc = mk_chunks(n=6, **data_kw)
    tw = Twin(chunk_len=T, batch=B, **fleet_kw)
    script(tw, jc, tc)


def test_fleet_arena_churn_matches_reference():
    """Arena on, both arena routes: every live query's enumerated sets
    after repacks equal the reference fleet's (and the cost report's arena
    cells/nodes)."""
    for arena_impl in ("block", "fold"):
        check_arena_churn(arena_impl)


def check_arena_churn(arena_impl):
    jc, tc = mk_chunks(5, 4)
    tw = Twin(chunk_len=T, batch=B, arena_capacity=1 << 12,
              arena_impl=arena_impl)
    qa, qb = tw.add(Q_A), tw.add(Q_B)
    hits = []
    for i in range(2):
        hits += tw.feed(jc[i], tc[i])[1]
    tw.remove(qb)                     # repack with the arena live
    qd = tw.add(Q_D)
    for i in (2, 3):
        hits += tw.feed(jc[i], tc[i])[1]
    assert tw.t.cost_report()[qa]["arena_nodes"] > 0

    def norm(ces):
        return {(int(c.start), int(c.end), tuple(map(int, c.data)))
                for c in ces}
    checked = 0
    for p, b in hits:
        for q in (qa, qd):
            want = norm(tw.j.enumerate(q, p, b))
            assert norm(tw.t.enumerate(q, p, b)) == want, (q, p, b)
            checked += bool(want)
    assert checked > 0


def test_fleet_mixed_strategies_enumerate_like_host_engine():
    """MAX, LAST, NEXT + CONSUME in one arena bucket: native enumeration
    at every position equals the port's host ``Engine`` with its host
    post-filter (the reference's arena with CONSUME compiles for most of a
    minute on one core, so this holds the port to the host instead)."""
    from repro_torch.core import compile_query
    from repro_torch.core.engine import Engine
    from repro_torch.core.selection import apply_strategy
    _, tc = mk_chunks(9, 3, types=("A", "B", "C"), attrs=(), chunk_len=4,
                      batch=1)
    f = QueryFleet(chunk_len=4, batch=1, epsilon=6, arena_capacity=256,
                   device="cpu")
    qids = [f.add_query(q) for q in MIXED]
    hits = []
    for chunk in tc:
        hits += f.feed(chunk)[1]
    stream = [ev for chunk in tc for ev in chunk[0]]
    checked = 0
    for qid, text in zip(qids, MIXED):
        cq = compile_query(text)
        eng = Engine(cq.cea, window=cq.query.window,
                     consume_on_match=cq.query.consume_on_match)
        want = [{(int(c.start), int(c.end), tuple(map(int, c.data)))
                 for c in apply_strategy(cq.query.strategy, eng.process(ev))}
                for ev in stream]
        for p, b in hits:
            got = {(int(c.start), int(c.end), tuple(map(int, c.data)))
                   for c in f.enumerate(qid, p, b)}
            assert got == want[p], (text, p)
            checked += bool(got)
    assert checked > 0


def test_fleet_compile_cache_100_ops_matches_reference():
    """~100 add/removes over a live stream: the cache counters follow
    the reference's op for op, and the survivors still match."""
    rng = np.random.default_rng(11)
    jc, tc = mk_chunks(4, 21)
    tw = Twin(leaves=False, chunk_len=T, batch=B)
    live = {q: (tw.add(q), 0) for q in POOL}
    ops, ci = 0, 0
    while ops < 100:
        q = POOL[int(rng.integers(0, len(POOL)))]
        if q in live and len(live) > 1:
            tw.remove(live.pop(q)[0])
        elif q not in live:
            live[q] = (tw.add(q), ci)
        else:
            continue
        ops += 1
        if ops % 5 == 0:
            tw.feed(jc[ci], tc[ci])
            ci += 1
    assert tw.t.compile_count <= tw.t.distinct_geometries <= 8
    assert tw.t.cache_hits >= 2 * ops // 3
    got = tw.feed(jc[ci], tc[ci])[0]
    leaves_equal(tw.t.snapshot()["arrays"], tw.j.snapshot()["arrays"])
    for q, (qid, added_at) in live.items():
        want = oracle_counts(q, tc[added_at:ci + 1])[-1]
        np.testing.assert_array_equal(
            got[:, :, tw.t.live_qids.index(qid)], want)


@settings(max_examples=5, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=len(POOL) - 1),
                min_size=1, max_size=10),
       st.integers(min_value=0, max_value=2 ** 31 - 1))
def test_fleet_random_churn_matches_reference(ops, seed):
    """Any interleaving of add/remove/feed: both fleets agree after every
    operation."""
    jc, tc = mk_chunks(seed % 1000, len(ops) + 1)
    tw = Twin(chunk_len=T, batch=B)
    live = {}
    tw.add(Q_A)
    fed = 0
    for op in ops:
        q = POOL[op]
        if q == Q_A:
            tw.feed(jc[fed], tc[fed])
            fed += 1
        elif q in live:
            tw.remove(live.pop(q))
        else:
            live[q] = tw.add(q)
    tw.feed(jc[fed], tc[fed])


# ---------------------------------------------------------------------------
# rollback, refusals, cache entries, devices
# ---------------------------------------------------------------------------

def test_fleet_bad_query_rolls_back_like_reference():
    jc, tc = mk_chunks(2, 2, attrs=("x", "y", "z", "u", "v"))
    tw = Twin(chunk_len=T, batch=B)
    tw.add(Q_W1)
    tw.feed(jc[0], tc[0])
    tw.add(Q_W2)
    for bad in ("THIS IS NOT CEQL", Q_TOO_WIDE):
        with pytest.raises(Exception) as ej:
            tw.j.add_query(bad)
        with pytest.raises(Exception) as et:
            tw.t.add_query(bad)
        assert type(et.value).__name__ == type(ej.value).__name__
        tw.check()                    # both fleets as they were
    tw.feed(jc[1], tc[1])
    for f in (tw.j, tw.t):
        with pytest.raises(KeyError):
            f.remove_query("nope")
        with pytest.raises(ValueError, match="already live"):
            f.add_query(Q_A, qid="q0")


def test_fleet_refusals_like_reference():
    """Restores the reference refuses, refused alike; ``device=None`` runs
    on CUDA and raises without it; an unknown ``impl`` raises."""
    if torch.cuda.is_available():
        assert QueryFleet(chunk_len=T, batch=B).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            QueryFleet(chunk_len=T, batch=B)
    with pytest.raises(ValueError, match="impl"):
        QueryFleet(chunk_len=T, batch=B, device="cpu", impl="bogus")
    jc, tc = mk_chunks(7, 1)
    tw = Twin(chunk_len=T, batch=B)
    tw.add(Q_A)
    tw.feed(jc[0], tc[0])
    snaps = {"repro": tw.j.snapshot(), "port": tw.t.snapshot()}
    for snap in snaps.values():
        bad = {"arrays": snap["arrays"],
               "meta": {**snap["meta"], "queries": {"q0": Q_B}}}
        other = {"arrays": snap["arrays"],
                 "meta": {**snap["meta"], "engine": "StreamingVectorEngine"}}
        for make in (JFleet, lambda **kw: QueryFleet(device="cpu", **kw)):
            with pytest.raises(ValueError, match="chunk_len"):
                make(chunk_len=2 * T, batch=B).restore(snap)
            with pytest.raises(ValueError, match="arena_capacity"):
                make(chunk_len=T, batch=B, arena_capacity=64).restore(snap)
            with pytest.raises(ValueError, match="fingerprint"):
                make(chunk_len=T, batch=B).restore(bad)
            with pytest.raises(ValueError, match="not a QueryFleet"):
                make(chunk_len=T, batch=B).restore(other)


@pytest.mark.parametrize("source", ["repro", "port"])
def test_fleet_snapshot_restores_across_packages(source):
    """A snapshot taken mid-churn by one package's fleet restores into the
    other's; both continue (more churn, more feeds) like a never-restored
    pair."""
    jc, tc = mk_chunks(6, 6)
    tw = Twin(chunk_len=T, batch=B)
    tw.add(Q_A)
    tw.add(Q_C)
    tw.feed(jc[0], tc[0])
    qb = tw.add(Q_B)
    tw.feed(jc[1], tc[1])
    snap = (tw.j if source == "repro" else tw.t).snapshot()
    back = Twin(chunk_len=T, batch=B)
    back.j.restore(snap)
    back.t.restore(snap)
    for pair in (tw, back):
        pair.check()
        pair.remove(qb)
        pair.add(Q_D)
        for i in (2, 3):
            pair.feed(jc[i], tc[i])
    assert_same_fleets(back.t, tw.t, counters=False)


def test_fleet_cache_entries_are_shared_and_record_first_runs():
    """An entry records its trace when it first runs, not when it is
    built; an arena entry keeps its tables across remove → re-add under a
    fresh qid; the CPU route loads no kernel library."""
    loads = LIBRARY.loads
    _, tc = mk_chunks(8, 2)
    f = QueryFleet(chunk_len=T, batch=B, arena_capacity=1 << 10,
                   device="cpu")
    assert isinstance(f._cache, CompileCache)
    qa = f.add_query(Q_A)
    assert (f.compile_count, f.distinct_geometries) == (0, 1)
    f.feed(tc[0])
    assert f.compile_count == 1
    tables = f._find_bucket(qa).engine._arena_tables
    f.remove_query(qa)
    qb = f.add_query(Q_A)
    assert qb != qa and f.cache_hits == 1
    assert f._find_bucket(qb).engine._arena_tables is tables
    f.feed(tc[1])
    assert (f.compile_count, f.distinct_geometries) == (1, 1)
    assert LIBRARY.loads == loads


# ---------------------------------------------------------------------------
# crash recovery and the service
# ---------------------------------------------------------------------------

_WORKER = textwrap.dedent("""
    import os, signal, sys
    import numpy as np
    from repro_torch.core.events import Event
    from repro_torch.runtime import QueryFleet, RecoveringStreamRunner

    Q_A, Q_B, Q_C = {queries!r}
    T, B = {T}, {B}
    directory, crash_after = sys.argv[1], int(sys.argv[2])
    rng = np.random.default_rng(8)
    chunks = [[[Event("E", {{"x": float(rng.integers(0, 10)),
                             "y": float(rng.integers(0, 10))}},
                      timestamp=float(c * T + t))
                for t in range(T)] for _ in range(B)] for c in range(12)]
    fleet = QueryFleet(chunk_len=T, batch=B, device="cpu")
    fleet.add_query(Q_A, qid="qa")

    def apply_churn(i, fleet):
        if i == 2: fleet.add_query(Q_B, qid="qb")
        if i == 5: fleet.add_query(Q_C, qid="qc")
        if i == 8: fleet.remove_query("qb")

    runner = RecoveringStreamRunner(fleet, directory, every=3)
    runner.resume()
    for i in range(runner.chunk_index, len(chunks)):
        apply_churn(i, fleet)
        runner.process(chunks[i])
        if runner.chunk_index == crash_after:
            os.kill(os.getpid(), signal.SIGKILL)
    runner.close()
    print("fleet-worker-done", sorted(fleet.live_qids))
""")


def test_fleet_kill9_crash_recovery_mid_churn(tmp_path):
    """kill -9 a port fleet worker mid-churn (checkpoint behind the log);
    the restarted worker's cumulative matches equal an uninterrupted run of
    the reference's fleet over the same chunks and churn."""
    import repro_torch
    worker = tmp_path / "fleet_worker.py"
    worker.write_text(_WORKER.format(queries=(Q_A, Q_B, Q_C), T=T, B=B))
    src = os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in (env.get("PYTHONPATH", ""),) if p])
    cmd = [sys.executable, str(worker)]

    # the reference, uninterrupted, in this process (mk_chunks(8) of
    # tests/test_fleet.py draws the same values)
    from test_fleet import mk_chunks as j_chunks
    d_ref = str(tmp_path / "reference")
    fleet = JFleet(chunk_len=T, batch=B)
    fleet.add_query(Q_A, qid="qa")
    runner = jrt.RecoveringStreamRunner(fleet, d_ref, every=3)
    for i, chunk in enumerate(j_chunks(8, 12)):
        if i == 2:
            fleet.add_query(Q_B, qid="qb")
        if i == 5:
            fleet.add_query(Q_C, qid="qc")
        if i == 8:
            fleet.remove_query("qb")
        runner.process(chunk)
    runner.close()
    oracle = jrt.cumulative_matches(d_ref)
    assert oracle["hits"], "workload produced no matches"

    d = str(tmp_path / "crashed")
    p = subprocess.run(cmd + [d, "8"], env=env)
    assert p.returncode == -signal.SIGKILL, p.returncode
    p = subprocess.run(cmd + [d, "-1"], env=env, capture_output=True,
                       text=True)
    assert p.returncode == 0, p.stderr
    assert "fleet-worker-done ['qa', 'qc']" in p.stdout
    assert cumulative_matches(d) == oracle


def test_service_fleet_restart_over_recovery_dir(tmp_path):
    """The port's twin of tests/test_service.py's fleet test: a batch-1
    fleet behind the service, then a restart over the same recovery
    directory skips the checkpointed prefix; ``matches.log`` is byte-equal
    to the reference service's at both steps."""
    made = {"repro": lambda: JFleet(chunk_len=8, batch=1,
                                    max_window_events=64),
            "port": lambda: QueryFleet(chunk_len=8, batch=1,
                                       max_window_events=64, device="cpu")}
    service = {"repro": jrt.StreamService, "port": StreamService}
    raws = make_raws(11, 64, dt=4.0)             # 8 exact chunks, no tail
    logs, alerts = {}, {}
    for pkg in ("repro", "port"):
        def mk():
            fleet = made[pkg]()
            fleet.add_query(QT_SERVICE, qid="q0")
            return fleet
        d = str(tmp_path / pkg)
        alerts[pkg] = []
        svc = service[pkg](mk(), d, checkpoint_every=4,
                           sinks=[lambda c, h, a=alerts[pkg]:
                                  a.append((c, list(h)))])
        assert svc.adapter.supports_regrow is False
        for r in raws:
            assert svc.submit(r, block=True, timeout=30.0).accepted
        svc.drain()                              # fleet: no pad support
        assert svc.metrics.chunks == 8
        svc.close()
        want = cumulative_matches(d)
        first = read(d, "matches.log")
        assert first

        svc2 = service[pkg](mk(), d, checkpoint_every=4)
        for r in raws:
            assert svc2.submit(r, block=True, timeout=30.0).accepted
        svc2.drain()
        assert svc2.metrics.skipped_chunks == 8  # whole prefix checkpointed
        assert svc2.metrics.chunks == 0
        svc2.close()
        assert cumulative_matches(d) == want     # restart-invariant
        logs[pkg] = (first, read(d, "matches.log"))
    assert logs["port"] == logs["repro"]
    assert alerts["port"] == alerts["repro"] and alerts["port"]
    with pytest.raises(ValueError, match="unsupported for QueryFleet"):
        _make_adapter(made["port"]()).pad_event()
