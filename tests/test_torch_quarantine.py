"""Quarantined lanes of the port's StreamingVectorEngine against the
reference package's, on the CPU route.

A lane parked mid-overflow-heal (``quarantine``) rides the snapshot
manifest as ``quarantined_lanes``, so a restore after a crash between the
quarantine and the completed regrow resumes the heal.  Snapshots cross
the two packages in both directions with their lanes, and ``reset`` and
``clear_quarantine`` empty them, as in the reference.
"""
import numpy as np
import pytest

from repro.data.streams import StreamSpec as JSpec
from repro.data.streams import random_stream as j_random
from repro.data.streams import stock_stream as j_stock
from repro.vector import StreamingVectorEngine as JStreaming
from repro.vector import VectorEngine as JVector
from repro_torch.data import StreamSpec as TSpec
from repro_torch.data import random_stream as t_random
from repro_torch.data import stock_stream as t_stock
from repro_torch.vector import StreamingVectorEngine as TStreaming
from repro_torch.vector import VectorEngine as TVector

STOCK_Q1 = """SELECT * FROM S
    WHERE SELL AS msft ; BUY AS oracle ; BUY AS csco ; SELL AS amat
    FILTER msft[name = 'MSFT'] AND oracle[name = 'ORCL'] AND
    csco[name = 'CSCO'] AND amat[name = 'AMAT']
    WITHIN 30000 [stock_time]"""
COUNT_Q = "SELECT * FROM S WHERE A1 ; A2+ ; A3 WITHIN 11 events"
B, T, CHUNK = 4, 48, 8


def chunks(ss, lo, hi):
    for a in range(lo, hi, CHUNK):
        yield [s[a:a + CHUNK] for s in ss]


def feed_both(js, ts, j_ss, t_ss, lo, hi):
    for jc, tc in zip(chunks(j_ss, lo, hi), chunks(t_ss, lo, hi)):
        jcount, jhits = js.feed(jc)
        tcount, thits = ts.feed(tc)
        np.testing.assert_array_equal(jcount, tcount)
        assert jhits == thits


def assert_state_equal(js, ts):
    ja, ta = js.snapshot()["arrays"], ts.snapshot()["arrays"]
    assert ja.keys() == ta.keys()
    for k in ja:
        np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)
    assert js.position == ts.position


def engines(kind):
    query, mwe = (STOCK_Q1, 8) if kind == "time" else (COUNT_Q, None)
    je = JVector(query, max_window_events=mwe, use_pallas=False)
    te = TVector(query, max_window_events=mwe, device="cpu")
    return JStreaming(je, CHUNK, B), TStreaming(te, CHUNK, B)


def streams(kind, seed=5):
    if kind == "time":   # fast enough to latch the 8-event rate bound
        make = [lambda s: j_stock(T, seed=s, events_per_sec=3.0),
                lambda s: t_stock(T, seed=s, events_per_sec=3.0)]
    else:
        make = [lambda s: j_random(JSpec(["A1", "A2", "A3"], seed=s), T),
                lambda s: t_random(TSpec(["A1", "A2", "A3"], seed=s), T)]
    return [[m(seed + b) for b in range(B)] for m in make]


@pytest.mark.parametrize("kind", ["count", "time"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_mid_quarantine_keeps_its_lanes(kind, direction):
    js, ts = engines(kind)
    j_ss, t_ss = streams(kind)
    src, src_ss = (js, j_ss) if direction == "jax_to_port" else (ts, t_ss)
    for c in chunks(src_ss, 0, 24):
        src.feed(c)
    # the heal parks the latched lanes (here: given unsorted, repeated)
    src.quarantine([3, 1, 3])
    assert src.quarantined_lanes == (1, 3)
    snap = src.snapshot()
    assert snap["meta"]["quarantined_lanes"] == [1, 3]
    dst = ts if direction == "jax_to_port" else js
    assert dst.quarantined_lanes == ()
    dst.restore(snap)
    assert dst.quarantined_lanes == (1, 3)
    assert js.manifest()["quarantined_lanes"] == \
        ts.manifest()["quarantined_lanes"] == [1, 3]
    # the quarantine is bookkeeping: both engines go on alike
    feed_both(js, ts, j_ss, t_ss, 24, T)
    assert_state_equal(js, ts)
    assert ts.quarantined_lanes == js.quarantined_lanes == (1, 3)


@pytest.mark.parametrize("how", ["reset", "clear_quarantine", "restore"])
def test_reset_clear_and_plain_restore_empty_the_lanes(how):
    js, ts = engines("count")
    j_ss, t_ss = streams("count")
    feed_both(js, ts, j_ss, t_ss, 0, 16)
    clean_j, clean_t = js.snapshot(), ts.snapshot()
    for eng in (js, ts):
        eng.quarantine([0, 2])
        assert eng.quarantined_lanes == (0, 2)
    if how == "restore":
        # a snapshot taken outside a heal restores with no lanes parked
        js.restore(clean_t)
        ts.restore(clean_j)
    else:
        for eng in (js, ts):
            getattr(eng, how)()
    assert js.quarantined_lanes == ts.quarantined_lanes == ()
    assert js.manifest()["quarantined_lanes"] == \
        ts.manifest()["quarantined_lanes"] == []
    if how == "clear_quarantine":   # the stream itself is untouched
        assert ts.position == js.position == 16
        assert_state_equal(js, ts)
    elif how == "reset":
        assert ts.position == js.position == 0
