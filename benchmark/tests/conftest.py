"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark
with one tiny cell added as files, which the harness runs on the CPU
through the port's plain kernel versions."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CELL = "tiny.cpu"
# the tiny cell's limits, set as control.py sets a cell's from the CPU's
# readings at this size (the port on seeds 1-30 and five above 2**31; the
# float8 control and the half-batch fault on seeds 1-3). Loss, grad, dense
# change, table change: the port reads up to 1.7e-4 / 9.1e-5 / 2.2e-3 /
# 6.6e-4; the control at least 6.9e-4 / 3.5e-2 / 5.9e-3 / 4.1e-4, the
# fault 5.9e-3 / 0.25 / 1.3e-2 / 1.8e-2. Limits at lower^0.4 * upper^0.6,
# upper the least reading of the control (where 3x the lower or more) and
# the fault (10x or more); at this size neither reaches that on the dense
# change, whose limit takes the control's 5.9e-3 (the control fails on
# grad_gap, the fault on every number)
TINY_LIMITS = {"loss_gap": 3.9e-4, "grad_gap": 3.2e-3,
               "change_median_gap": 4.0e-3, "change_table_gap": 4.7e-3}


BAGS_CELL = "bags.cpu"
# the bags cell's limits: the bags program reads at most 1.1e-7 / 1.6e-7 /
# 1.1e-7 / 2.9e-8 on seeds 1-40 and 2**31 + 1..5 (loss, grad, dense change,
# table change); its bfloat16 control at least 8.3e-5 / 1.9e-3 / 9.0e-4 /
# 9.4e-2 and the half-batch fault 1.4e-3 / 0.41 / 9.3e-2 / 0.32 on seeds 1-5
BAGS_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-5,
               "change_median_gap": 1e-5, "change_table_gap": 1e-5}
HERE = Path(__file__).resolve().parent


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


def add_tiny_cell(root: Path, hidden=(64, 32), vocab=5000, dim=16,
                  rows=4096, batch=512, t=8) -> None:
    """A configuration, a traffic mix and a cell, each a new file, and
    their entries in root's BENCHMARK.json."""
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "sparse_din_v10m_d64.json")
                     .read_text())
    cfg["name"] = "tiny"
    cfg["model"].update(item_vocab=vocab, emb_dim=dim, hidden=list(hidden))
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    law = json.loads((bench / "traffic" / "zipf_t32_b65k.json").read_text())
    law.update(rows=rows, batch=batch, t=t)
    (bench / "traffic" / "tiny.json").write_text(json.dumps(law))
    (bench / "cells" / f"{TINY_CELL}.json").write_text(
        json.dumps({"limits": TINY_LIMITS, "epoch_s": 0.1}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "a CPU test"})
    spec["workloads"].append({"name": TINY_CELL, "config": "tiny",
                              "traffic": "tiny", "chips": 1,
                              "why": "a CPU test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def add_bags_cell(root: Path) -> None:
    """A family that shares nothing with sparse_din (bags_family.py, its
    reference bags_reference.py), a configuration, a traffic mix and a
    cell, each a new file, and their entries in root's BENCHMARK.json."""
    bench = root / "benchmark"
    shutil.copy(HERE / "bags_family.py", bench / "families" / "bags.py")
    shutil.copy(HERE / "bags_reference.py",
                bench / "families" / "bags_reference.py")
    cfg = {"name": "bags", "family": "bags",
           "reference": "benchmark/families/bags_reference.py",
           "model": {"vocab": 3000, "dim": 8, "dense": 5, "dtype": "float32"},
           "sgd": {"lr": 0.5}}
    (bench / "configs" / "bags.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "bags.json").write_text(
        json.dumps({"rows": 2048, "batch": 256, "bag": 6}))
    (bench / "cells" / f"{BAGS_CELL}.json").write_text(
        json.dumps({"limits": BAGS_LIMITS, "epoch_s": 0.1}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "bags", "source": "test",
                            "file": "benchmark/configs/bags.json",
                            "reduced": [], "why": "a CPU test"})
    spec["workloads"].append({"name": BAGS_CELL, "config": "bags",
                              "traffic": "bags", "chips": 1,
                              "why": "a CPU test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of BENCHMARK.json and benchmark/ under tmp_path."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


@pytest.fixture
def tiny_bench(bench_copy):
    from benchmark.registry import Bench

    add_tiny_cell(bench_copy)
    return Bench(bench_copy)


@pytest.fixture
def bags_bench(bench_copy):
    from benchmark.registry import Bench

    add_bags_cell(bench_copy)
    return Bench(bench_copy)


@pytest.fixture
def tiny_bags(bench_copy):
    """The copy with both the tiny sparse_din cell and the bags cell."""
    from benchmark.registry import Bench

    add_tiny_cell(bench_copy)
    add_bags_cell(bench_copy)
    return Bench(bench_copy)
