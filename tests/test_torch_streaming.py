"""The port's StreamingVectorEngine against the reference package's, on the
CPU route (tolerance 0: counts, rings and latches must be identical)."""
import numpy as np
import pytest
import torch

from repro.data.streams import StreamSpec as JSpec
from repro.data.streams import random_stream as j_random
from repro.data.streams import stock_stream as j_stock
from repro.kernels.window import WindowOverflowError as JOverflow
from repro.vector import StreamingVectorEngine as JStreaming
from repro.vector import VectorEngine as JVector
from repro_torch.data import StreamSpec as TSpec
from repro_torch.data import random_stream as t_random
from repro_torch.data import stock_stream as t_stock
from repro_torch.kernels.window import WindowOverflowError as TOverflow
from repro_torch.vector import StreamingVectorEngine as TStreaming
from repro_torch.vector import VectorEngine as TVector

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.restore(ts.snapshot(), migrate_packing=True)
    for call in (lambda: te.classify(None), lambda: te.scan(None, None),
                 lambda: te.partitioned_streaming(("name",), 8, 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


def test_engine_defaults_to_cuda():
    query = CASES["count"][0]
    if torch.cuda.is_available():
        assert TVector(query).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TVector(query)
    assert TVector(query, device="cpu").device.type == "cpu"
