"""The port's checkpoints, recovery runner and fault-tolerance primitives
against the reference package's, on the CPU route.

The same snapshots and streams, made from seeds, go through ``repro``'s
``CheckpointManager``/``RecoveringStreamRunner`` and ``repro_torch``'s.
Tolerance 0: manifests and ``.npy`` files are byte-identical, a recovery
directory written by either package resumes in the other, and the
cumulative emitted match sets (counts and hits) are equal.
"""
import json
import os
import random
import threading
import time

import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import Event as JEvent
from repro.runtime import MatchLog as JMatchLog
from repro.runtime import RecoveringStreamRunner as JRunner
from repro.runtime import cumulative_matches as j_cumulative
from repro.vector import PartitionedStreamingEngine as JPart
from repro.vector import VectorEngine as JVector
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.events import Event as TEvent
from repro_torch.kernels.window import WindowOverflowError
from repro_torch.runtime import (HeartbeatMonitor, MatchLog,
                                 RecoveringStreamRunner, RetryPolicy,
                                 StepTimer, cumulative_matches,
                                 run_with_retries)
from repro_torch.vector import PartitionedStreamingEngine as TPart
from repro_torch.vector import VectorEngine as TVector

QTEXT = "SELECT * FROM S WHERE A ; B+ ; C WITHIN 5 events"
QT_TIME = "SELECT * FROM S WHERE A ; B+ ; C WITHIN 7 seconds"
CHUNK, TOTAL, EVERY = 16, 320, 4


def keyed_raw(seed, T, keys=("u1", "u2", 7, None), p_missing=0.05):
    """(type, attrs) pairs of one interleaved stream (NULL keys and events
    without the key attribute included)."""
    rng = random.Random(seed)
    return [(rng.choice("ABCX"),
             {} if rng.random() < p_missing else {"uid": rng.choice(keys)})
            for _ in range(T)]


def chunks_of(raw, cls, size=CHUNK):
    evs = [cls(t, dict(a)) for t, a in raw]
    return [evs[lo:lo + size] for lo in range(0, len(evs), size)]


def j_engine(arena=1 << 12):
    return JPart(JVector(QTEXT, use_pallas=False), ("uid",),
                 chunk_len=CHUNK, num_lanes=8, arena_capacity=arena)


def t_engine(arena=1 << 12):
    return TPart(TVector(QTEXT, device="cpu"), ("uid",), chunk_len=CHUNK,
                 num_lanes=8, arena_capacity=arena)


def run_all(runner, chunks, stop=None):
    """Feed ``chunks`` from the runner's cursor (up to ``stop``); returns
    the ``emitted`` flags."""
    flags = []
    for ch in chunks[runner.chunk_index:stop]:
        flags.append(runner.process(ch)[2])
    return flags


@pytest.fixture(scope="module")
def stream():
    return keyed_raw(9, TOTAL)


@pytest.fixture(scope="module")
def oracle(stream, tmp_path_factory):
    """Uninterrupted runs of both packages over the same stream: their
    cumulative match sets, which must agree."""
    base = tmp_path_factory.mktemp("oracle")
    out = {}
    for name, runner_cls, eng, cls in (
            ("repro", JRunner, j_engine, JEvent),
            ("port", RecoveringStreamRunner, t_engine, TEvent)):
        d = str(base / name)
        r = runner_cls(eng(), d, every=EVERY)
        assert not r.resume()
        assert all(run_all(r, chunks_of(stream, cls)))
        r.close()
        out[name] = (d, cumulative_matches(d))
    assert out["port"][1] == out["repro"][1] == j_cumulative(out["repro"][0])
    assert out["port"][1]["hits"]
    with open(os.path.join(out["port"][0], "matches.log"), "rb") as f, \
            open(os.path.join(out["repro"][0], "matches.log"), "rb") as g:
        assert f.read() == g.read()           # the emission log, byte-exact
    return out["port"][1]


# ---------------------------------------------------------------------------
# checkpoint files cross packages
# ---------------------------------------------------------------------------

def assert_same_step_dirs(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        with open(os.path.join(a, name), "rb") as f, \
                open(os.path.join(b, name), "rb") as g:
            assert f.read() == g.read(), name


def test_engine_snapshot_files_match_the_reference(tmp_path):
    """A time-window partitioned snapshot with the arena (f32 rings, bool
    latches, uint32 lane keys, int32 nodes, int64 roots, the audit carry):
    both managers write byte-identical manifests and ``.npy`` files, and
    each loads the other's."""
    raw = [(t, a) for t, a in keyed_raw(4, 64)]
    eng = TPart(TVector(QT_TIME, max_window_events=16, device="cpu"),
                ("uid",), chunk_len=CHUNK, num_lanes=4,
                arena_capacity=1 << 10)
    evs = [TEvent(t, dict(a), timestamp=i / 4)
           for i, (t, a) in enumerate(raw)]
    for lo in range(0, 64, CHUNK):
        eng.feed(evs[lo:lo + CHUNK])
    snap = eng.snapshot()
    assert snap["arrays"]["state/lane_keys"].dtype == np.uint32
    assert "roots_key" in snap["arrays"]
    extra = dict(snap["meta"], chunk=4)
    mine, theirs = CheckpointManager(str(tmp_path / "port")), \
        JManager(str(tmp_path / "repro"))
    mine.save(4, snap["arrays"], extra=extra)
    theirs.save(4, snap["arrays"], extra=extra)
    assert_same_step_dirs(tmp_path / "port" / "step_4",
                          tmp_path / "repro" / "step_4")
    for m, other in ((mine, theirs), (theirs, mine)):
        arrays, meta = m.load_arrays()
        got, got_meta = other.load_arrays()
        assert meta == got_meta == json.loads(json.dumps(extra))
        assert arrays.keys() == got.keys() == snap["arrays"].keys()
        for k, v in snap["arrays"].items():
            assert arrays[k].dtype == v.dtype
            np.testing.assert_array_equal(arrays[k], v)
    # the port's engine restores from the reference's files
    eng2 = TPart(TVector(QT_TIME, max_window_events=16, device="cpu"),
                 ("uid",), chunk_len=CHUNK, num_lanes=4,
                 arena_capacity=1 << 10)
    arrays, meta = theirs.load_arrays()
    eng2.restore({"arrays": arrays, "meta": meta})
    tail = [TEvent("ABC"[i % 3], {"uid": "u1"}, timestamp=16.0 + i)
            for i in range(CHUNK)]
    c1, h1 = eng.feed(tail)
    c2, h2 = eng2.feed(tail)
    np.testing.assert_array_equal(c1, c2)
    assert h1 == h2


def test_nested_tree_of_tensors_matches_the_reference(tmp_path):
    """Nested dicts, lists and None, torch tensors (uint32 included) on the
    port's side and the same values as numpy on the reference's: the same
    leaf order, keys, dtypes and bytes; ``restore`` rebuilds the tree."""
    rng = np.random.default_rng(0)
    np_tree = {"w": rng.standard_normal((4, 3)).astype(np.float32),
               "b": {"k": np.array([1, 2 ** 32 - 1, 7], np.uint32),
                     "c": np.zeros((2, 2), np.int32)},
               "l": [np.arange(3, dtype=np.int64), np.ones(2, np.bool_)],
               "n": None, "a/b": np.float32(2.5) * np.ones(1, np.float32)}
    t_tree = {"w": torch.from_numpy(np_tree["w"].copy()),
              "b": {"k": torch.from_numpy(np_tree["b"]["k"].copy()),
                    "c": torch.zeros((2, 2), dtype=torch.int32)},
              "l": [torch.arange(3), torch.ones(2, dtype=torch.bool)],
              "n": None, "a/b": torch.full((1,), 2.5)}
    mine = CheckpointManager(str(tmp_path / "port"))
    theirs = JManager(str(tmp_path / "repro"))
    mine.save(1, t_tree, extra={"note": "x"})
    theirs.save(1, np_tree, extra={"note": "x"})
    assert_same_step_dirs(tmp_path / "port" / "step_1",
                          tmp_path / "repro" / "step_1")
    restored, extra = mine.restore(np_tree)
    assert extra == {"note": "x"} and restored["n"] is None
    for got, want in ((restored["w"], np_tree["w"]),
                      (restored["b"]["k"], np_tree["b"]["k"]),
                      (restored["l"][0], np_tree["l"][0]),
                      (restored["l"][1], np_tree["l"][1]),
                      (restored["a/b"], np_tree["a/b"])):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="shape mismatch"):
        mine.restore({"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="missing leaf"):
        mine.restore({"zz": np.zeros(1)})


def test_checkpoint_atomicity(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    tree = {"a": torch.ones(4), "b": {"c": torch.zeros((2, 2))}}
    ckpt.save(1, tree)
    # a crashed (partial) write must be invisible to restore
    os.makedirs(tmp_path / "step_2.tmp")
    restored, _ = ckpt.restore(tree)
    assert ckpt.latest_step() == 1
    np.testing.assert_array_equal(restored["a"], np.ones(4, np.float32))
    assert JManager(str(tmp_path)).latest_step() == 1   # same rule there
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).load_arrays()


def test_checkpoint_async_and_gc(tmp_path):
    """Async saves copy device tensors before returning (the caller may go
    on updating them), publish in save order, and keep the newest two."""
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    w = torch.arange(8.0)
    for s in (1, 2, 3, 4):
        w += 1.0                        # in place, as an engine's state
        ckpt.save(s, {"w": w}, blocking=False)
    ckpt.wait()
    assert ckpt.all_steps() == [3, 4]
    for s in (3, 4):
        arrays, _ = ckpt.load_arrays(s)
        np.testing.assert_array_equal(arrays["w"],
                                      np.arange(8.0, dtype=np.float32) + s)


# ---------------------------------------------------------------------------
# the emission log
# ---------------------------------------------------------------------------

def test_matchlog_torn_tail_and_high_water(tmp_path):
    for name, cls in (("port", MatchLog), ("repro", JMatchLog)):
        path = str(tmp_path / f"{name}.log")
        log = cls(path)
        log.append(0, np.asarray([0, 2, 0]), [1])
        log.append(1, np.asarray([1, 0, 0]), [(3, 0)])
        log.close()
        with open(path, "a") as f:
            f.write('{"chunk": 2, "shape": [3], "cou')   # torn mid-write
    with open(tmp_path / "port.log", "rb") as f, \
            open(tmp_path / "repro.log", "rb") as g:
        assert f.read() == g.read()
    log2 = MatchLog(str(tmp_path / "repro.log"))   # the port repairs theirs
    assert log2.high_water() == 1                   # torn record invisible
    cum = log2.cumulative()
    assert cum["hits"] == [1, (3, 0)]
    assert cum["counts"] == {(0, 1): 2, (1, 0): 1}
    log2.append(2, np.asarray([0, 0, 3]), [5])      # appends after repair
    log2.close()
    assert MatchLog(str(tmp_path / "repro.log")).high_water() == 2
    assert JMatchLog(str(tmp_path / "repro.log")).cumulative() == \
        MatchLog(str(tmp_path / "repro.log")).cumulative()


# ---------------------------------------------------------------------------
# exactly-once across packages and after a crash
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("first", ["repro", "port"])
def test_recovery_directory_resumes_across_packages(first, stream, oracle,
                                                    tmp_path):
    """One package runs chunks 0-10 (checkpoints at 4 and 8, the log
    through 10) and is abandoned; the other resumes from the checkpoint at
    8, replays 8-10 with emission suppressed and completes the stream."""
    pkgs = {"repro": (JRunner, j_engine, JEvent),
            "port": (RecoveringStreamRunner, t_engine, TEvent)}
    second = "port" if first == "repro" else "repro"
    d = str(tmp_path / "crossed")
    runner_cls, eng, cls = pkgs[first]
    r1 = runner_cls(eng(), d, every=EVERY)
    run_all(r1, chunks_of(stream, cls), stop=11)    # kill -9: no close()
    r1.manager.wait()
    runner_cls, eng, cls = pkgs[second]
    r2 = runner_cls(eng(), d, every=EVERY)
    assert r2.resume() and r2.chunk_index == 8 and r2.replaying
    flags = run_all(r2, chunks_of(stream, cls))
    r2.close()
    assert flags == [False] * 3 + [True] * 9
    assert cumulative_matches(d) == oracle == j_cumulative(d)


def test_runner_exactly_once_after_simulated_crash(stream, oracle,
                                                   tmp_path):
    """Abandon the runner mid-interval with a torn tail record: the
    restarted runner resumes from the checkpoint, suppresses replayed
    chunks, and the cumulative match set equals the uninterrupted run's."""
    chunks = chunks_of(stream, TEvent)
    d = str(tmp_path / "crashed")
    r1 = RecoveringStreamRunner(t_engine(), d, every=EVERY)
    run_all(r1, chunks, stop=11)
    with open(os.path.join(d, "matches.log"), "a") as f:
        f.write('{"chunk": 99, "torn')
    r2 = RecoveringStreamRunner(t_engine(), d, every=EVERY)
    assert r2.latest_manifest()["chunk"] == 8
    assert r2.resume()
    assert r2.chunk_index == 8 and r2.replaying
    flags = run_all(r2, chunks)
    r2.close()
    assert flags == [False] * 3 + [True] * 9
    assert cumulative_matches(d) == oracle


def test_runner_detects_divergent_replay(tmp_path):
    """Replaying different input under the high-water mark raises instead
    of silently corrupting the exactly-once record."""
    mk = lambda: TPart(TVector(QTEXT, device="cpu"), ("uid",),
                       chunk_len=16, num_lanes=8)
    d = str(tmp_path / "div")
    matching = [TEvent(t, {"uid": "u1"}) for t in "ABCABCABCABCABCA"]
    chunks = chunks_of(keyed_raw(11, 16), TEvent) + \
        chunks_of(keyed_raw(12, 16), TEvent) + [matching]
    r1 = RecoveringStreamRunner(mk(), d, every=2)
    recorded = [r1.process(ch)[0] for ch in chunks]
    assert recorded[2].sum() > 0
    r1.close()
    r2 = RecoveringStreamRunner(mk(), d, every=2)
    r2.resume()
    assert r2.chunk_index == 2 and r2.replaying
    with pytest.raises(ValueError, match="diverged"):
        r2.process([TEvent("X", {"uid": "u1"})] * 16)
    r2.close()


def test_runner_rejects_bad_interval_and_denies_overflow(tmp_path):
    with pytest.raises(ValueError, match="interval"):
        RecoveringStreamRunner(t_engine(None), str(tmp_path / "r"), every=0)
    eng = TPart(TVector(QT_TIME, max_window_events=8, device="cpu"),
                ("uid",), chunk_len=16, num_lanes=4, strict_overflow=True)
    calls = [0]
    feed = eng.feed

    def counted(evs):
        calls[0] += 1
        return feed(evs)
    eng.feed = counted
    r = RecoveringStreamRunner(eng, str(tmp_path / "ovf"))
    dense = [TEvent("A", {"uid": "a"}, timestamp=i * 0.1)
             for i in range(16)]
    with pytest.raises(WindowOverflowError):
        r.process(dense)
    assert calls[0] == 1                  # never retried: crash-only
    r.close()


# ---------------------------------------------------------------------------
# retries, heartbeat, stragglers
# ---------------------------------------------------------------------------

def test_run_with_retries_backoff():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("boom")
        return 42

    assert run_with_retries(flaky, RetryPolicy(max_retries=3,
                                               backoff_s=0.01)) == 42
    assert calls["n"] == 3


def test_run_with_retries_exhausts():
    def always():
        raise RuntimeError("nope")

    with pytest.raises(RuntimeError):
        run_with_retries(always, RetryPolicy(max_retries=2, backoff_s=0.01))


def test_latest_checkpoint_read_survives_a_concurrent_collection(
        stream, tmp_path):
    """An async save that publishes a newer step and collects the one the
    runner just found (between ``latest_step`` and ``load_arrays``): the
    runner reads the newer step instead of failing on a deleted file."""
    chunks = chunks_of(stream, TEvent)
    d = str(tmp_path / "gc")
    r1 = RecoveringStreamRunner(t_engine(), d, every=EVERY, keep=1)
    run_all(r1, chunks, stop=2 * EVERY + 1)
    r1.close()
    r2 = RecoveringStreamRunner(t_engine(), d, every=EVERY, keep=1)
    newest = r2.manager.latest_step()
    found = iter([newest - 1])
    real = r2.manager.latest_step
    r2.manager.latest_step = lambda: next(found, None) or real()
    assert r2.latest_manifest()["chunk"] == 2 * EVERY
    assert r2.resume() and r2.chunk_index == 2 * EVERY
    r2.close()


def test_heartbeat_detects_hang():
    hung = threading.Event()
    hb = HeartbeatMonitor(timeout_s=0.1, poll_s=0.02,
                          on_hang=hung.set).start()
    time.sleep(0.3)
    hb.stop()
    assert hb.hung and hung.is_set()


def test_heartbeat_stays_quiet_when_beating():
    hb = HeartbeatMonitor(timeout_s=0.2, poll_s=0.02).start()
    for _ in range(10):
        time.sleep(0.05)
        hb.beat()
    hb.stop()
    assert not hb.hung


def test_straggler_detection():
    t = StepTimer(straggler_factor=3.0)
    for _ in range(16):
        t.observe(0.01)
    assert t.observe(0.2) is True
    assert not t.observe(0.011)
    assert len(t.stragglers) == 1
    with StepTimer() as s:
        pass
    assert len(s.times) == 1 and s.median == s.times[0]
