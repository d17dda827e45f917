"""The port's StreamingVectorEngine against the reference package's, on the
CPU route (tolerance 0: counts, rings and latches must be identical)."""
import gc
import random
import sys

import numpy as np
import pytest
import torch

from repro.core.events import Event as JEvent
from repro.data.streams import StreamSpec as JSpec
from repro.data.streams import random_stream as j_random
from repro.data.streams import stock_stream as j_stock
from repro.kernels.window import WindowOverflowError as JOverflow
from repro.vector import StreamingVectorEngine as JStreaming
from repro.vector import VectorEngine as JVector
from repro.vector import multiquery as jmq
from repro_torch.core.events import Event as TEvent
from repro_torch.data import StreamSpec as TSpec
from repro_torch.data import random_stream as t_random
from repro_torch.data import stock_stream as t_stock
from repro_torch.kernels.window import WindowOverflowError as TOverflow
from repro_torch.runtime.recovery import MatchLog, _hit_key
from repro_torch.vector import HitList
from repro_torch.vector import StreamingVectorEngine as TStreaming
from repro_torch.vector import VectorEngine as TVector
from repro_torch.vector import multiquery as tmq

STOCK_Q1 = """SELECT * FROM S
    WHERE SELL AS msft ; BUY AS oracle ; BUY AS csco ; SELL AS amat
    FILTER msft[name = 'MSFT'] AND oracle[name = 'ORCL'] AND
    csco[name = 'CSCO'] AND amat[name = 'AMAT']
    WITHIN 30000 [stock_time]"""
STOCK_Q3 = STOCK_Q1 + " CONSUME BY ANY"
TYPES = ["A1", "A2", "A3"]

CASES = {
    "count": ("SELECT * FROM S WHERE A1 ; A2+ ; A3 WITHIN 11 events", None),
    "last": ("SELECT LAST * FROM S WHERE A1 ; A2 WITHIN 13 events", None),
    "consume": ("SELECT * FROM S WHERE A1 ; A2 ; A3 WITHIN 9 events "
                "CONSUME BY ANY", None),
    "time": (STOCK_Q1, 48),
    "time_consume": (STOCK_Q3, 48),
    "time_overflow": (STOCK_Q1, 8),
}


def streams(kind, B, T, seed):
    """Equal event streams for both packages, from the same seeds."""
    if kind.startswith("time"):
        rate = 3.0 if kind == "time_overflow" else 1.0
        make = [lambda s: j_stock(T, seed=s, events_per_sec=rate),
                lambda s: t_stock(T, seed=s, events_per_sec=rate)]
    else:
        make = [lambda s: j_random(JSpec(TYPES, seed=s), T),
                lambda s: t_random(TSpec(TYPES, seed=s), T)]
    return [[m(seed + b) for b in range(B)] for m in make]


def engines(kind, chunk, B, strict=False):
    query, mwe = CASES[kind]
    je = JVector(query, max_window_events=mwe, use_pallas=False)
    te = TVector(query, max_window_events=mwe, device="cpu")
    return (JStreaming(je, chunk, B, strict_overflow=strict),
            TStreaming(te, chunk, B, strict_overflow=strict))


def chunks(ss, lo, hi, chunk):
    for a in range(lo, hi, chunk):
        yield [s[a:a + chunk] for s in ss]


def assert_state_equal(js, ts):
    ja, ta = js.snapshot()["arrays"], ts.snapshot()["arrays"]
    assert ja.keys() == ta.keys()
    for k in ja:
        assert ja[k].dtype == ta[k].dtype, k
        np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)
    assert js.position == ts.position
    np.testing.assert_array_equal(js.window_overflow, ts.window_overflow)


def feed_both(js, ts, j_ss, t_ss, lo, hi, chunk):
    for jc, tc in zip(chunks(j_ss, lo, hi, chunk), chunks(t_ss, lo, hi,
                                                        chunk)):
        jcount, jhits = js.feed(jc)
        tcount, thits = ts.feed(tc)
        assert tcount.dtype == np.int64
        np.testing.assert_array_equal(jcount, tcount)
        assert jhits == thits


@pytest.mark.parametrize("kind", sorted(CASES))
@pytest.mark.parametrize("chunk", [8, 12])
def test_streaming_matches_reference(kind, chunk):
    B, T = 3, 48
    js, ts = engines(kind, chunk, B)
    j_ss, t_ss = streams(kind, B, T, seed=17)
    feed_both(js, ts, j_ss, t_ss, 0, T, chunk)
    assert_state_equal(js, ts)
    if kind == "time_overflow":
        assert ts.window_overflow.any()
    assert ts.compile_count == 0  # the plain route builds no kernel


def test_strict_overflow_raises_like_reference():
    B, T, chunk = 2, 48, 12
    js, ts = engines("time_overflow", chunk, B, strict=True)
    j_ss, t_ss = streams("time_overflow", B, T, seed=3)
    for jc, tc in zip(chunks(j_ss, 0, T, chunk), chunks(t_ss, 0, T, chunk)):
        with pytest.raises(JOverflow) as j_err:
            js.feed(jc)
        with pytest.raises(TOverflow) as t_err:
            ts.feed(tc)
        assert j_err.value.lanes == t_err.value.lanes
        break
    assert_state_equal(js, ts)   # the chunk was applied before the raise
    assert not issubclass(TOverflow, RuntimeError)


@pytest.mark.parametrize("kind", ["count", "time", "time_consume", "last"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshots_interoperate(kind, direction):
    B, T, chunk = 2, 48, 8
    js, ts = engines(kind, chunk, B)
    j_ss, t_ss = streams(kind, B, T, seed=29)
    src, src_ss = (js, j_ss) if direction == "jax_to_port" else (ts, t_ss)
    for c in chunks(src_ss, 0, 24, chunk):
        src.feed(c)
    dst = ts if direction == "jax_to_port" else js
    dst.restore(src.snapshot())
    feed_both(js, ts, j_ss, t_ss, 24, T, chunk)
    assert_state_equal(js, ts)


def test_snapshot_refuses_other_query():
    js, _ = engines("count", 8, 2)
    _, ts = engines("consume", 8, 2)
    with pytest.raises(ValueError, match="incompatible"):
        ts.restore(js.snapshot())


def test_regrow_matches_reference():
    B, T, chunk = 2, 48, 12
    js, ts = engines("time_overflow", chunk, B)
    j_ss, t_ss = streams("time", B, T, seed=41)
    feed_both(js, ts, j_ss, t_ss, 0, 24, chunk)
    js.regrow(40)
    ts.regrow(40)
    assert ts.window.ring == js.window.ring == 40
    assert_state_equal(js, ts)
    feed_both(js, ts, j_ss, t_ss, 24, T, chunk)
    assert_state_equal(js, ts)
    with pytest.raises(ValueError, match="shrink"):
        ts.regrow(8)


def test_ragged_chunks_refused():
    _, ts = engines("count", 8, 2)
    _, t_ss = streams("count", 2, 5, seed=0)
    with pytest.raises(ValueError, match="chunk_len"):
        ts.feed(t_ss)
    with pytest.raises(ValueError, match="chunk_len"):
        ts.feed_attrs(torch.zeros((8, 3, 3)))


def test_reset_rewinds_and_keeps_buffers():
    _, ts = engines("time", 8, 2)
    _, t_ss = streams("time", 2, 16, seed=5)
    buf = ts.state["C"]
    first = [ts.feed(c)[0] for c in chunks(t_ss, 0, 16, 8)]
    ts.reset()
    assert ts.position == 0 and ts.state["C"] is buf
    second = [ts.feed(c)[0] for c in chunks(t_ss, 0, 16, 8)]
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    assert ts.state["C"] is buf   # feeds update the preallocated buffer


def test_unported_paths_raise():
    te = TVector(CASES["count"][0], device="cpu")
    ts = TStreaming(te, 8, 2)
    # classify, scan and migrate_packing are ported (test_torch_unfused.py,
    # test_torch_multiquery.py); a single-query engine has no packing
    with pytest.raises(ValueError, match="packing specs on both sides"):
        ts.restore(ts.snapshot(), migrate_packing=True)
    # PARTITION BY is ported too (test_torch_partitioned.py)
    pse = te.partitioned_streaming(("name",), 8, 2)
    assert type(pse).__name__ == "PartitionedStreamingEngine"
    assert pse.num_lanes == 2 and pse.chunk_len == 8


def test_engine_defaults_to_cuda():
    query = CASES["count"][0]
    if torch.cuda.is_available():
        assert TVector(query).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TVector(query)
    assert TVector(query, device="cpu").device.type == "cpu"


PACKED = [f"SELECT * FROM S WHERE {q} WITHIN 7 events"
          for q in ("A1 ; A2 ; A3", "A1 ; A2+ ; A3", "A2 ; A3")]


@pytest.mark.parametrize("kind", ["single", "packed"])
def test_hit_list_holds_the_pair_contract(kind, tmp_path):
    """``feed``'s HitList equals the reference's list of pairs, in order,
    and serves what its callers do with it: tuples of ints, sets, length,
    truth, indexing, slices, ``(n, 2)`` arrays, list concatenation, the
    match log's JSON; a feed with no hits gives an empty one."""
    B, T, chunk = 8, 48, 12
    if kind == "single":
        js, ts = engines("count", chunk, B)
    else:
        js = JStreaming(jmq.MultiQueryEngine(PACKED, use_pallas=False),
                        chunk, B)
        ts = TStreaming(tmq.MultiQueryEngine(PACKED, device="cpu"), chunk, B)
    j_ss, t_ss = streams("count", B, T, seed=5)
    log = MatchLog(str(tmp_path / "matches.log"))
    fed = []
    for k, (jc, tc) in enumerate(zip(chunks(j_ss, 0, T, chunk),
                                     chunks(t_ss, 0, T, chunk))):
        jcount, jhits = js.feed(jc)
        tcount, thits = ts.feed(tc)
        np.testing.assert_array_equal(jcount, tcount)
        assert tcount.ndim == (2 if kind == "single" else 3)
        assert isinstance(thits, HitList)
        assert thits == jhits and jhits == thits and thits.tolist() == jhits
        assert all(type(h) is tuple and len(h) == 2
                   and all(type(x) is int for x in h) for h in thits)
        assert set(thits) == set(jhits) and len(thits) == len(jhits)
        assert bool(thits) == bool(jhits)
        assert [thits[i] for i in range(len(thits))] == jhits
        np.testing.assert_array_equal(np.asarray(thits, np.int64),
                                      np.asarray(jhits, np.int64).reshape(-1, 2))
        log.append(k, tcount, thits)
        fed.append(thits)
    hits = max(fed, key=len)
    want = hits.tolist()
    assert len(want) >= 4
    assert isinstance(hits[1:-1], HitList) and hits[1:-1] == want[1:-1]
    assert hits[::2] == want[::2] and hits[-1] == want[-1]
    assert hits == [list(h) for h in want] and hits != want[:-1]
    assert np.asarray(hits).shape == (len(want), 2)
    assert [(0, 0)] + hits == [(0, 0)] + want
    assert hits + [(0, 0)] == want + [(0, 0)]
    acc = []
    for f in fed:
        acc += f
    assert acc == [h for f in fed for h in f.tolist()]
    log.close()
    back = MatchLog(log.path)
    assert [[_hit_key(h) for h in r["hits"]] for r in back.records] == \
        [f.tolist() for f in fed]
    back.close()
    # A2 ends no query's match
    _, jnone = js.feed([[JEvent("A2")] * chunk for _ in range(B)])
    _, tnone = ts.feed([[TEvent("A2")] * chunk for _ in range(B)])
    assert jnone == [] and tnone == jnone and not tnone and len(tnone) == 0
    assert np.asarray(tnone, np.int64).shape == (0, 2)


def test_feed_allocates_no_object_a_hit():
    """The hit list is two arrays: a feed ending about 10 000 matches
    leaves no more live Python objects than one ending about 10 (a tuple a
    hit would leave some 10 000 more)."""
    T, B = 64, 512
    ts = TStreaming(TVector("SELECT * FROM S WHERE A1 ; A3 WITHIN 2 events",
                            device="cpu"), T, B)
    rng = random.Random(11)

    def attrs(n_hits):
        """Lanes of A1 A3 pairs: ``n_hits`` A3s, the rest A2."""
        types = ["A2"] * (T * B)
        for i in rng.sample(range(T * B // 2), n_hits):
            types[2 * i:2 * i + 2] = ["A1", "A3"]
        ss = [[TEvent(types[b * T + t]) for t in range(T)] for b in range(B)]
        return torch.from_numpy(ts.encoder.encode_streams(ss))

    def live_blocks(a):
        gc.collect()
        before = sys.getallocatedblocks()
        out = ts.feed_attrs(a)
        gc.collect()
        return sys.getallocatedblocks() - before, out

    sparse, dense = attrs(10), attrs(10_000)
    live_blocks(dense)            # first-call set-up
    d_sparse, (_, h_sparse) = live_blocks(sparse)
    d_dense, (_, h_dense) = live_blocks(dense)
    assert len(h_sparse) == 10 and len(h_dense) == 10_000
    assert d_dense - d_sparse < 100, (d_sparse, d_dense)
