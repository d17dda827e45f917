"""The engine's spans (``repro_torch.trace.span``) on the CPU: three spans a
``feed_attrs`` under a profiler, in order and inside the caller's span;
nothing built without one; the same counts and hits either way."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import trace
from repro_torch.vector import MultiQueryEngine, StreamingVectorEngine

QUERIES = ["SELECT * FROM S WHERE A1 ; A2 ; A3 WITHIN 40 events",
           "SELECT * FROM S WHERE B1 ; B2 WITHIN 40 events"]
TYPES = ["A1", "A2", "A3", "B1", "B2", "C"]
SPANS = ("streaming.device_step", "streaming.counts_to_host",
         "streaming.hit_list")
T, B, N_FEEDS = 16, 4, 5


def chunks(eng):
    """``N_FEEDS`` chunks of (T, B, 1) type codes drawn from a fixed seed."""
    vocab = eng.encoder.vocab["type"]
    codes = torch.tensor([vocab.get(t, -1.0) for t in TYPES],
                         dtype=torch.float32)
    g = torch.Generator().manual_seed(7)
    return [codes[torch.randint(len(TYPES), (T, B), generator=g)]
            .unsqueeze(-1) for _ in range(N_FEEDS)]


def feed_all(prof=None):
    """Every chunk through a new engine, each feed inside a ``feed`` span
    when ``prof`` records; the feeds' outputs."""
    eng = MultiQueryEngine(QUERIES, device="cpu")
    stream = StreamingVectorEngine(eng, T, B)
    out = []
    for attrs in chunks(eng):
        if prof is None:
            out.append(stream.feed_attrs(attrs))
        else:
            with record_function("feed"):
                out.append(stream.feed_attrs(attrs))
    return out


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One profiled run: its outputs and its chrome trace's spans by name."""
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = feed_all(prof)
    prof.export_chrome_trace(str(path))
    spans = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            a = float(e["ts"])
            spans.setdefault(e["name"], []).append((a, a + float(e["dur"])))
    return out, {k: sorted(v) for k, v in spans.items()}


def test_each_feed_holds_its_three_spans_in_order(traced):
    _, spans = traced
    feeds = spans["feed"]
    assert len(feeds) == N_FEEDS
    for s, e in feeds:
        inside = [[iv for iv in spans[n] if s <= iv[0] and iv[1] <= e]
                  for n in SPANS]
        assert [len(x) for x in inside] == [1, 1, 1]
        (a0, b0), (a1, b1), (a2, b2) = (x[0] for x in inside)
        assert a0 <= b0 <= a1 <= b1 <= a2 <= b2
    for n in SPANS:
        assert len(spans[n]) == N_FEEDS


def test_without_a_profiler_no_record_function_is_built(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("a") is trace.span("b")
    with trace.span("a"), trace.span("a"):
        pass
    assert len(feed_all()) == N_FEEDS


def test_under_a_profiler_span_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]):
        s = trace.span("a")
        assert isinstance(s, record_function)
    assert trace.span("a") is trace.span("b")


def test_counts_and_hits_equal_with_the_profiler_on_and_off(traced):
    on, _ = traced
    off = feed_all()
    assert sum(len(h) for _, h in off) > 0
    for (c_on, h_on), (c_off, h_off) in zip(on, off):
        assert c_on.dtype == c_off.dtype == np.int64
        np.testing.assert_array_equal(c_on, c_off)
        assert h_on == h_off
