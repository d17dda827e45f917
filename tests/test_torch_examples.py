"""The port's examples (``examples/torch_quickstart.py``,
``examples/torch_multi_query.py``, ``examples/torch_train_small.py``)
against the reference package's (``examples/quickstart.py``,
``examples/multi_query.py``, ``examples/train_small.py``) on the CPU: the
same printed lines (for training, lines of the same form), and per-position
counts equal to ``repro``'s engines on the same streams."""
import dataclasses
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np

from repro.data.streams import stock_stream
from repro.vector import VectorEngine
from repro.vector.multiquery import MultiQueryEngine

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_the_reference_example(capsys):
    ref = load("quickstart")
    port = load("torch_quickstart")
    assert port.QUERY == ref.QUERY
    ref.main()
    want = capsys.readouterr().out
    got = port.main(["--device", "cpu"])
    assert capsys.readouterr().out == want
    streams = [stock_stream(4096, seed=s) for s in range(8)]
    counts, _ = VectorEngine("SELECT * FROM S WHERE SELL AS a ; BUY AS b "
                             "FILTER a[price > 25.0] AND b[price < 10.0] "
                             "WITHIN 100 events").run(streams)
    np.testing.assert_array_equal(got["counts"], np.asarray(counts))
    tstream = stock_stream(2048, seed=7, events_per_sec=4.0)
    tcounts, _ = VectorEngine("SELECT * FROM S WHERE SELL AS a ; BUY AS b "
                              "FILTER a[price > 25.0] AND b[price < 10.0] "
                              "WITHIN 30 seconds",
                              max_window_events=256).run([tstream])
    np.testing.assert_array_equal(got["tcounts"], np.asarray(tcounts))


def test_multi_query_matches_the_reference_example(capsys):
    ref = load("multi_query")
    port = load("torch_multi_query")
    assert port.QUERIES == ref.QUERIES
    ref.main()
    want = capsys.readouterr().out
    got = port.main(["--device", "cpu"])
    assert capsys.readouterr().out == want
    streams = [stock_stream(4096, seed=s) for s in range(8)]
    counts, _ = MultiQueryEngine(list(ref.QUERIES.values()),
                                 epsilon=60).run(streams)
    np.testing.assert_array_equal(got["counts"], np.asarray(counts))
    assert got["counts"].max() < 2 ** 24


def test_train_small_has_the_reference_example_form(capsys, monkeypatch):
    """3 steps of batch 2 × 16 on the CPU: the same config, monitor and
    first line as ``examples/train_small.py``, its other lines of the same
    form, and a loss that descends over the port's batches.  The
    reference's own loss-descent assert does not hold at 3 steps over its
    batches (9.353 → 9.658), so its lines are read before that assert
    raises."""
    ref = load("train_small")
    port = load("torch_train_small")
    assert port.MONITOR == ref.MONITOR
    assert dataclasses.asdict(port.small_config("qwen3-32b")) == \
        dataclasses.asdict(ref.small_config("qwen3-32b"))
    monkeypatch.setattr(sys, "argv", ["train_small", "--steps", "3",
                                      "--batch", "2", "--seq", "16"])
    try:
        ref.main()
    except AssertionError:
        pass
    want = capsys.readouterr().out.splitlines()
    got = port.main(["--steps", "3", "--batch", "2", "--seq", "16",
                     "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(want) == 3
    assert lines[0] == want[0] == "model: qwen3-32b family, 21.0M params"
    forms = [r"loss: \d+\.\d{3} → \d+\.\d{3} over 3 steps "
             r"\(median step \d+ ms\)",
             r"CER monitor fired \d+ times \(loss-spike triple within 20 "
             r"steps\)"]
    for form, a, b in zip(forms, want[1:], lines[1:]):
        assert re.fullmatch(form, a), a
        assert re.fullmatch(form, b), b
    losses = [m["loss"] for m in got["metrics"]]
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert got["report"]["final_step"] == 3
