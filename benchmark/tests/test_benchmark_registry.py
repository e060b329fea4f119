"""The benchmark is driven by data: every file loads by name, names and
units keep to the allowed letters, a cell and a metric added as new files
are picked up with no edit, and nothing it runs imports JAX."""
import ast
import json
from pathlib import Path

import pytest

from benchmark import registry
from conftest import TINY_CELL, add_tiny_cell

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "goctr_tpu"}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_loads_by_name(cell):
    b = registry.Bench(ROOT)
    c = b.cell(cell)
    assert c.chips == 1
    assert c.config["family"] == "sparse_din"
    assert Path(c.family.__file__) == BENCH / "families" / "sparse_din.py"
    assert {"model", "trainer", "table_opt"} <= set(c.config)
    assert {"rows", "batch", "t", "ids"} <= set(c.traffic)
    assert set(c.limits) == {"loss_gap", "grad_gap", "change_median_gap",
                             "change_table_gap"}
    assert [m["name"] for m in c.end_to_end] == [
        "train_examples_per_s", "peak_device_gb", "setup_s"]
    assert len(c.per_layer) == len(SPEC["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_metric_reader_loads(metric):
    assert callable(registry.Bench(ROOT).reader(metric))


def test_names_and_units_are_allowed():
    registry.check_names(SPEC)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert registry.UNIT.match(m["unit"]) and len(m["unit"]) <= 16
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
    bad = json.loads(json.dumps(SPEC))
    bad["end_to_end"][0]["unit"] = "examples per second"
    with pytest.raises(ValueError):
        registry.check_names(bad)


def test_new_cell_and_metric_are_files(bench_copy):
    add_tiny_cell(bench_copy)
    (bench_copy / "benchmark" / "metrics" / "steps_read.py").write_text(
        "def read(t):\n    return float(t.steps)\n")
    spec = json.loads((bench_copy / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "steps_read", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "model step",
        "moves": "train_examples_per_s", "workloads": [TINY_CELL]})
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(spec))
    b = registry.Bench(bench_copy)
    cell = b.cell(TINY_CELL)
    assert cell.config["model"]["item_vocab"] == 5000
    assert "steps_read" in [m["name"] for m in cell.per_layer]
    assert b.reader("steps_read")(type("T", (), {"steps": 7})()) == 7.0
    assert "steps_read" not in [m["name"] for m in
                                b.cell(SPEC["workloads"][0]["name"]).per_layer]


def _imports(path: Path, whole: bool = False) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out if whole else {m.split(".")[0] for m in out}


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    """Each configuration's reference takes from the benchmark only the
    family interface's types, which are themselves port-free."""
    for c in SPEC["configs"]:
        ref = ROOT / json.loads((ROOT / c["file"]).read_text())["reference"]
        assert _imports(ref, whole=True) <= {
            "__future__", "dataclasses", "typing", "math", "numpy", "torch",
            "benchmark.families"}, ref
    assert _imports(BENCH / "families" / "__init__.py") <= {
        "__future__", "dataclasses", "torch"}


@pytest.mark.parametrize("name", ["harness.py", "check.py", "counts.py",
                                  "trace.py", "registry.py", "control.py",
                                  "run.py", "families/__init__.py"])
def test_generic_modules_import_nothing_of_the_port(name):
    """What every family shares drives the program only through the
    family's module."""
    assert "goctr_tpu_torch" not in _imports(BENCH / name), name
