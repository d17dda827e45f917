"""The engines' spans (``repro_torch.trace.span``) on the CPU: three spans a
``feed_attrs`` and four a ``feed_keyed`` (the partitioned engine records
the same three under the same names, and its routing stats' copy) under a
profiler, in order and inside the caller's span; nothing built without
one; the same counts, hits and routing stats either way, with a packed
engine."""
import json
from dataclasses import asdict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import trace
from repro_torch.vector import (MultiQueryEngine, PartitionedStreamingEngine,
                                StreamingVectorEngine)

QUERIES = ["SELECT * FROM S WHERE A1 ; A2 ; A3 WITHIN 40 events",
           "SELECT * FROM S WHERE B1 ; B2 WITHIN 40 events"]
TYPES = ["A1", "A2", "A3", "B1", "B2", "C"]
SPANS = ("streaming.device_step", "streaming.counts_to_host",
         "streaming.hit_list")
KEYED_SPANS = ("streaming.device_step", "partitioned.stats_to_host",
               "streaming.counts_to_host", "streaming.hit_list")
T, B, N_FEEDS = 16, 4, 5
#: the keyed feeds' chunk, lanes, lane cap and keys (one more key than
#: lanes, so some spill)
KT, L, CAP, N_KEYS = 64, 4, 24, 6


def type_codes(eng):
    vocab = eng.encoder.vocab["type"]
    return torch.tensor([vocab.get(t, -1.0) for t in TYPES],
                        dtype=torch.float32)


def chunks(eng):
    """``N_FEEDS`` chunks of (T, B, 1) type codes drawn from a fixed seed."""
    codes = type_codes(eng)
    g = torch.Generator().manual_seed(7)
    return [codes[torch.randint(len(TYPES), (T, B), generator=g)]
            .unsqueeze(-1) for _ in range(N_FEEDS)]


def keyed_chunks(eng):
    """``N_FEEDS`` chunks of (KT, 1) type codes and (KT,) key hashes drawn
    from a fixed seed; key 0 stands for NULL."""
    codes = type_codes(eng)
    g = torch.Generator().manual_seed(11)
    hashes = torch.tensor([0xFFFFFFFF] + [1000 + 7 * k
                                          for k in range(1, N_KEYS)])
    return [(codes[torch.randint(len(TYPES), (KT,), generator=g)]
             .unsqueeze(-1),
             hashes[torch.randint(N_KEYS, (KT,), generator=g)])
            for _ in range(N_FEEDS)]


def feed_all(prof=None, keyed=False):
    """Every chunk through a new engine (the partitioned one if
    ``keyed``), each feed inside a ``feed`` span when ``prof`` records;
    the feeds' outputs, and for ``keyed`` also the routing stats."""
    eng = MultiQueryEngine(QUERIES, device="cpu")
    if keyed:
        stream = PartitionedStreamingEngine(eng, ("uid",), KT, L,
                                            lane_cap=CAP)
        feed, args = stream.feed_keyed, keyed_chunks(eng)
    else:
        stream = StreamingVectorEngine(eng, T, B)
        feed, args = stream.feed_attrs, [(a,) for a in chunks(eng)]
    out = []
    for a in args:
        if prof is None:
            out.append(feed(*a))
        else:
            with record_function("feed"):
                out.append(feed(*a))
    return (out, asdict(stream.stats)) if keyed else out


def profiled(tmp_path_factory, keyed):
    """One profiled run: its outputs and its chrome trace's spans by name."""
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = feed_all(prof, keyed)
    prof.export_chrome_trace(str(path))
    spans = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            a = float(e["ts"])
            spans.setdefault(e["name"], []).append((a, a + float(e["dur"])))
    return out, {k: sorted(v) for k, v in spans.items()}


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    return profiled(tmp_path_factory, False)


@pytest.fixture(scope="module")
def traced_keyed(tmp_path_factory):
    return profiled(tmp_path_factory, True)


def assert_spans_in_order(spans, names):
    """Each ``feed`` span holds one of each of ``names``, one after the
    other in that order, and no span of ``names`` lies outside them."""
    feeds = spans["feed"]
    assert len(feeds) == N_FEEDS
    for s, e in feeds:
        inside = [[iv for iv in spans[n] if s <= iv[0] and iv[1] <= e]
                  for n in names]
        assert [len(x) for x in inside] == [1] * len(names)
        ends = [t for x in inside for t in x[0]]
        assert ends == sorted(ends)
    for n in set(names):
        assert len(spans[n]) == N_FEEDS


def assert_same_outputs(on, off, shape):
    """Equal int64 counts of ``shape`` and equal hits, some of them."""
    assert sum(len(h) for _, h in off) > 0
    for (c_on, h_on), (c_off, h_off) in zip(on, off):
        assert c_on.dtype == c_off.dtype == np.int64
        assert c_on.shape == shape
        np.testing.assert_array_equal(c_on, c_off)
        assert h_on == h_off


def refuse_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled


def test_each_feed_holds_its_three_spans_in_order(traced):
    assert_spans_in_order(traced[1], SPANS)


def test_each_keyed_feed_holds_its_four_spans_in_order(traced_keyed):
    assert_spans_in_order(traced_keyed[1], KEYED_SPANS)


def test_without_a_profiler_no_record_function_is_built(monkeypatch):
    refuse_record_function(monkeypatch)
    assert trace.span("a") is trace.span("b")
    with trace.span("a"), trace.span("a"):
        pass
    assert len(feed_all()) == N_FEEDS


def test_without_a_profiler_a_keyed_feed_builds_no_record_function(
        monkeypatch):
    refuse_record_function(monkeypatch)
    out, _ = feed_all(keyed=True)
    assert len(out) == N_FEEDS


def test_under_a_profiler_span_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]):
        s = trace.span("a")
        assert isinstance(s, record_function)
    assert trace.span("a") is trace.span("b")


def test_counts_and_hits_equal_with_the_profiler_on_and_off(traced):
    assert_same_outputs(traced[0], feed_all(), (T, B, len(QUERIES)))


def test_keyed_counts_hits_and_stats_equal_with_the_profiler_on_and_off(
        traced_keyed):
    (on, stats_on), _ = traced_keyed
    off, stats_off = feed_all(keyed=True)
    # the draws route, drop NULL keys and find the lanes taken
    assert stats_off["dropped_null"] > 0
    assert stats_off["spilled_table"] + stats_off["evicted_lanes"] > 0
    assert stats_on == stats_off
    assert_same_outputs(on, off, (KT, len(QUERIES)))
