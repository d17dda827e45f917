"""``BENCHMARK.json`` against the benchmark's contract, and every item it
names found by name under ``bench/``; the harness's imports.  CPU only,
no program run.  Items are looped over inside a few tests: a file of 16
tests or fewer queues after the suite's larger files under xdist's
``--dist loadfile`` and leaves their order as it was."""
import ast
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def one_line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_run_seconds():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert isinstance(SPEC["run_seconds"], int) and \
        1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43 200 seconds
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_one_line_fields():
    for item in SPEC["configs"] + SPEC["workloads"] + METRICS:
        assert NAME.match(item["name"]), item["name"]
        for key in ("why", "layer", "source"):
            if key in item:
                assert one_line(item[key]), (item["name"], key)
        if "unit" in item:
            assert UNIT.match(item["unit"]), item["name"]
            assert item["better"] in ("lower", "higher"), item["name"]
        for key in ("config", "traffic"):
            if key in item:
                assert NAME.match(item[key]), (item["name"], key)


def test_names_are_unique():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [i["name"] for i in group]
        assert len(names) == len(set(names))


def test_config_files_are_found_by_name():
    for cfg in SPEC["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert cfg["file"] == f"bench/configs/{cfg['name']}.json"
        data = json.loads((ROOT / cfg["file"]).read_text())
        assert data["source"] == cfg["source"]
        assert data["reduced"] == cfg["reduced"]
        assert "assumed" in data
        assert (BENCH / "reference" / f"{data['reference']}.py").is_file()
        assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


def test_cell_files_are_found_by_name():
    for cell in SPEC["workloads"]:
        check_cell(cell)


def check_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    data = json.loads((BENCH / "workloads" / f"{cell['name']}.json")
                      .read_text())
    assert data["config"] == cell["config"]
    assert (BENCH / "entries" / f"{data['entry']}.py").is_file()
    assert (BENCH / "traffic" / f"{data['traffic']['generator']}.py"
            ).is_file()
    for b in data["bounds"]:
        assert (BENCH / "bounds" / f"{b}.py").is_file()
    assert 0 < data["check"]["sample_share"] <= 1
    # every cell reports set-up, one more end-to-end and a per-layer metric
    e2e = [m["name"] for m in SPEC["end_to_end"]
           if cell["name"] in m.get("workloads", CELLS)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in m.get("workloads", CELLS)
               for m in SPEC["per_layer"])


def test_metric_readers_are_found_by_name():
    for metric in METRICS:
        check_metric(metric)


def check_metric(metric):
    assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in [m["name"] for m in SPEC["end_to_end"]]
        assert set(metric["workloads"]) <= set(CELLS)
        assert set(metric) == {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


def imports_of(path: Path) -> set:
    """Top-level names of every absolute import in a source file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    for path in sorted(BENCH.rglob("*.py")):
        assert not imports_of(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        assert imports_of(path) <= {"numpy", "torch", "math", "typing"}, path
