"""The port's tables, encodings, windows and fingerprints are byte-identical
to the reference package's (tolerance: none — exact bytes)."""
import numpy as np
import pytest
import torch

from benchmarks.cer_paper import D3, D5, K3, K5, STOCK_QUERIES
from benchmarks.perf_cer import QUERIES
from repro.core import compile_query as j_compile
from repro.data.streams import StreamSpec as JSpec
from repro.data.streams import random_stream as j_random
from repro.data.streams import stock_stream as j_stock
from repro.kernels import window as j_window
from repro.vector import StreamingVectorEngine as JStreaming
from repro.vector import VectorEngine as JVector
from repro.vector.symbolic import compile_symbolic as j_symbolic
from repro_torch.core import compile_query as t_compile
from repro_torch.data import StreamSpec as TSpec
from repro_torch.data import random_stream as t_random
from repro_torch.data import stock_stream as t_stock
from repro_torch.kernels import window as t_window
from repro_torch.vector import StreamingVectorEngine as TStreaming
from repro_torch.vector import VectorEngine as TVector
from repro_torch.vector import VectorQueryTables
from repro_torch.vector.symbolic import compile_symbolic as t_symbolic

BASE = "SELECT {s}* FROM S WHERE A1 ; A2+ ; A3 WITHIN 20 events{c}"
VARIANTS = [BASE.format(s=s, c=c)
            for s in ("", "STRICT ", "MAX ", "NXT ", "LAST ")
            for c in ("", " CONSUME BY ANY") if (s, c) != ("STRICT ",
                                                          " CONSUME BY ANY")]
COUNT_QUERIES = ([q + " WITHIN 50 events" for q in QUERIES]
                 + [q + " WITHIN 100 events" for q in (K3, K5, D3, D5)]
                 + VARIANTS)
ALL_QUERIES = COUNT_QUERIES + list(STOCK_QUERIES.values())


def _bytes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("query", ALL_QUERIES)
def test_symbolic_tables_byte_identical(query):
    jc, tc = j_compile(query), t_compile(query)
    strategy = jc.semantics.construction
    assert tc.semantics == type(tc.semantics)(**vars(jc.semantics))
    js, ts = j_symbolic(jc.cea, strategy), t_symbolic(tc.cea, strategy)
    assert (js.num_states, js.num_classes, js.num_bits, js.strategy) == \
        (ts.num_states, ts.num_classes, ts.num_bits, ts.strategy)
    for name in ("class_of", "delta_mark", "delta_unmark", "finals"):
        _bytes_equal(getattr(js, name), getattr(ts, name))
    _bytes_equal(js.transition_matrices(), ts.transition_matrices())


@pytest.mark.parametrize("query", ALL_QUERIES)
def test_engine_tables_and_fingerprint_byte_identical(query):
    mwe = 64 if "stock_time" in query else None
    je = JVector(query, max_window_events=mwe)
    te = TVector(query, max_window_events=mwe, device="cpu")
    assert vars(je.window) == vars(te.window)
    for name in ("m_all", "finals", "class_of", "class_ind", "init_mask",
                 "latest_q", "consume_sq"):
        a, b = getattr(je.tables, name), getattr(te.tables, name)
        assert (a is None) == (b is None), name
        if a is not None:
            _bytes_equal(np.asarray(a), b.numpy())
    names = ("m_all", "finals", "class_of", "class_ind", "init_mask")
    carried = VectorQueryTables.from_numpy(
        *(np.asarray(getattr(je.tables, n)) for n in names),
        latest_q=je.tables.latest_q, consume_sq=je.tables.consume_sq,
        device="cpu")
    for name in names + ("num_states", "num_classes", "num_bits"):
        a, b = getattr(carried, name), getattr(te.tables, name)
        if isinstance(a, torch.Tensor):
            _bytes_equal(a.numpy(), b.numpy())
        else:
            assert a == b, name
    assert je.encoder.specs == te.encoder.specs
    assert je.encoder.attrs == te.encoder.attrs
    assert je.encoder.vocab == te.encoder.vocab
    js, ts = JStreaming(je, chunk_len=8, batch=2), TStreaming(te, 8, 2)
    assert js.query_fingerprint() == ts.query_fingerprint()
    jm, tm = js.manifest(), ts.manifest()
    for key in TStreaming._compat_keys:
        assert jm[key] == tm[key], key


def test_strict_consume_rejected_at_construction():
    q = BASE.format(s="STRICT ", c=" CONSUME BY ANY")
    with pytest.raises(ValueError, match="STRICT") as j_err:
        JVector(q)
    with pytest.raises(ValueError, match="STRICT") as t_err:
        TVector(q, device="cpu")
    assert str(j_err.value) == str(t_err.value)


@pytest.mark.parametrize("mwe", [None, 1, 9, 100, 3000])
@pytest.mark.parametrize("spec", [("events", 0), ("events", 7),
                                  ("events", 3200), ("time", 30000.0),
                                  ("time", 2.5)])
def test_resolve_window_rings(spec, mwe):
    from repro.core.engine import WindowSpec as JWS
    from repro_torch.core.engine import WindowSpec as TWS
    kind, size = spec
    results = []
    for ws, resolve in ((JWS(kind, float(size)), j_window.resolve_window),
                        (TWS(kind, float(size)), t_window.resolve_window)):
        try:
            results.append(vars(resolve(ws, max_window_events=mwe)))
        except ValueError as e:
            results.append(str(e).split("(DESIGN")[0].split(" — ")[0])
    assert results[0] == results[1]


@pytest.mark.parametrize("old,new,pos", [(8, 16, [0, 5, 8, 23]),
                                         (64, 72, [3, 64, 100, 1000])])
def test_ring_slot_remap_identical(old, new, pos):
    a = j_window.ring_slot_remap(old, new, np.asarray(pos))
    b = t_window.ring_slot_remap(old, new, np.asarray(pos))
    for x, y in zip(a, b):
        _bytes_equal(x, y)


@pytest.mark.parametrize("kind", ["random", "stock"])
def test_encoder_output_byte_identical(kind):
    if kind == "random":
        query = QUERIES[2] + " WITHIN 50 events"
        js = [j_random(JSpec(["A1", "A2", "A3"], seed=s), 24)
              for s in range(3)]
        ts = [t_random(TSpec(["A1", "A2", "A3"], seed=s), 24)
              for s in range(3)]
    else:
        query = STOCK_QUERIES["Q2"]
        js = [j_stock(24, seed=s) for s in range(3)]
        ts = [t_stock(24, seed=s) for s in range(3)]
    je = JVector(query, max_window_events=None if kind == "random" else 32)
    te = TVector(query, max_window_events=None if kind == "random" else 32,
                 device="cpu")
    _bytes_equal(je.encoder.encode_streams(js), te.encoder.encode_streams(ts))
    for base in (0, 7):
        ja, jt = je.encoder.encode_streams_ts(js, je.window.time_attr,
                                              base_pos=base)
        ta, tt = te.encoder.encode_streams_ts(ts, te.window.time_attr,
                                              base_pos=base)
        _bytes_equal(ja, ta)
        _bytes_equal(jt, tt)
    j_attrs, j_ts = je.encode_ts(js)
    t_attrs, t_ts = te.encode_ts(ts)
    _bytes_equal(np.asarray(j_attrs), t_attrs.numpy())
    assert (j_ts is None) == (t_ts is None)
    if j_ts is not None:
        _bytes_equal(np.asarray(j_ts), t_ts.numpy())
