"""The port's examples (``examples/torch_quickstart.py``,
``examples/torch_multi_query.py``) against the reference package's
(``examples/quickstart.py``, ``examples/multi_query.py``) on the CPU: the
same printed lines, and per-position counts equal to ``repro``'s engines
on the same streams."""
import importlib.util
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
