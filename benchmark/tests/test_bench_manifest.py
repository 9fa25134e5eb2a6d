"""BENCHMARK.json against the benchmark's contract, and every cell found
by name: its configuration, traffic mix, op kind and metric readers."""

import ast
import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_of_24_cells_fits():
    """2 + 14 runs a cell, each run_seconds + 60 s, 180 s of compiles a
    cell and 1,200 s spare, within 43,200 s."""
    cells = 24
    total = ((2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180
             + 1200)
    assert total <= 43200


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units_use_the_allowed_characters(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in e.get("reduced", []):
            assert NAME.match(key)
        for key in ("why", "source", "layer"):
            if key in e and key != "source" or (key == "source"
                                                and section == "configs"):
                v = e[key]
                assert 1 <= len(v) <= 200 and "\n" not in v and "\t" not in v


def test_one_four_card_cell_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_setup_s_and_the_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for cell in CELLS:
        got = [m["name"] for m in BENCH["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        assert "setup_s" in got and len(got) >= 2
        assert any(cell in m.get("workloads", CELLS)
                   for m in BENCH["per_layer"])


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert cell in moved.get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_by_name(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"]
                                    if w["name"] == cell)
    assert harness.op_module(c.traffic["op"]).Op is not None
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]))


def test_configuration_files():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in data


def test_traffic_mixes_are_data():
    for w in BENCH["workloads"]:
        path = ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json"
        assert "op" in json.loads(path.read_text())


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted((ROOT / "benchmark").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_nothing_imports_jax_or_the_jax_package(path):
    """Compared by whole top-level name: paillier_tpu_torch passes."""
    bad = _imports(path) & {"jax", "jaxlib", "flax", "paillier_tpu"}
    assert not bad


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        assert not _imports(path) & {"paillier_tpu_torch", "torch",
                                     "paillier_tpu", "jax"}, path


def test_the_benchmark_reads_none_of_the_old_bench():
    for path in SOURCES:
        text = path.read_text()
        for name in ("bench.py", "chip_smoke", "BENCH_r", "scripts/"):
            assert name not in text or path.name.startswith("test_"), \
                (path, name)
