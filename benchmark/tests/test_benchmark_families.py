"""Families: a configuration's `family` picks its module by path, an
unknown one fails by name; sparse_din reads on the tiny cell what the
harness read before it became a family; and a family added to a copy of
the benchmark as new files only (bags_family.py, sharing nothing with
sparse_din) runs through the harness, correct, and not correct under a
planted fault."""
import hashlib
import json
import math
import time
from pathlib import Path

import pytest
import torch

from benchmark import check, harness, registry
from conftest import BAGS_CELL, BAGS_LIMITS, TINY_CELL

CPU = torch.device("cpu")
PARENT = json.loads((Path(__file__).resolve().parent
                     / "sparse_din_tiny_seed1.json").read_text())
RTOL = 1e-6


def run(bench, cell, seed, traced=False):
    line, _, _ = harness.run_cell(bench, bench.cell(cell), seed, 0.5, traced,
                                  CPU, time.perf_counter())
    return line


def test_family_is_loaded_by_path_from_the_bench_root(tiny_bags):
    for cell, name in ((TINY_CELL, "sparse_din"), (BAGS_CELL, "bags")):
        fam = tiny_bags.cell(cell).family
        assert Path(fam.__file__) == (tiny_bags.root / "benchmark"
                                      / "families" / f"{name}.py").resolve()
    assert tiny_bags.cell(TINY_CELL).family is tiny_bags.family("sparse_din")


@pytest.mark.parametrize("family", ["no_such_family", "../sparse_din", None])
def test_unknown_family_fails_naming_it(tiny_bench, family):
    cfg_file = tiny_bench.root / "benchmark" / "configs" / "tiny.json"
    cfg = json.loads(cfg_file.read_text())
    if family is None:
        del cfg["family"]
    else:
        cfg["family"] = family
    cfg_file.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match=f"family {family!r}"):
        registry.Bench(tiny_bench.root).cell(TINY_CELL)


def test_sparse_din_draw_is_the_parents(tiny_bench):
    prep = harness.prepare(tiny_bench.cell(TINY_CELL), PARENT["seed"], CPU)
    assert {k: hashlib.sha256(v.tobytes()).hexdigest()
            for k, v in prep.arrays.items()} == PARENT["sha256"]
    assert prep.rows == 4096 and prep.cap == PARENT["cap"]
    assert prep.unique_share == PARENT["unique_share"]


def _close(got, want):
    assert len(got.losses) == len(want["losses"])
    pairs = list(zip(got.losses, want["losses"]))
    for part in ("grad", "change"):
        assert set(getattr(got, part)) == set(want[part]), part
        pairs += [(getattr(got, part)[k], want[part][k]) for k in want[part]]
    for g, w in pairs:
        assert g == pytest.approx(w, rel=RTOL, abs=0)


def test_sparse_din_readings_are_the_parents(tiny_bench):
    cell, seed = tiny_bench.cell(TINY_CELL), PARENT["seed"]
    prep = harness.prepare(cell, seed, CPU)
    _, first, _, over, _ = harness.program_first(cell, prep, seed, CPU)
    assert over == 0
    _close(first, PARENT["program"])
    _close(harness.reference_first(cell, prep, seed, CPU),
           PARENT["reference"])


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_new_family_runs_from_new_files(bags_bench, traced):
    line = run(bags_bench, BAGS_CELL, 2**31 + 3, traced)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 2 * 8
    assert set(line["checks"]) == set(BAGS_LIMITS) | {
        "overflow", "nonfinite", "epochs_off", "launches_off"}
    if traced:
        # din_pool_roofline lists the sparse_din cells alone
        assert "din_pool_roofline" not in line["metrics"]
        assert "step_mfu_pct" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"train_examples_per_s",
                                        "peak_device_gb", "setup_s"}


def _half_batch_loss(real):
    def loss(p, b):
        keep = b["labels"].shape[0] // 2
        return real(p, {k: v[:keep] for k, v in b.items()})
    return loss


@pytest.mark.parametrize("fault", ["half_batch", "control"])
def test_new_family_fails_under_a_fault(bags_bench, monkeypatch, fault):
    cell = bags_bench.cell(BAGS_CELL)
    if fault == "half_batch":
        monkeypatch.setattr(cell.family, "loss",
                            _half_batch_loss(cell.family.loss))
        line = run(bags_bench, BAGS_CELL, 2**31 + 3)
        assert not line["correct"], line["checks"]
        return
    _, precision = cell.family.control(cell.config)
    for seed in (1, 2, 3):
        prep = harness.prepare(cell, seed, CPU)
        ref = harness.reference_first(cell, prep, seed, CPU)
        low = harness.reference_first(cell, prep, seed, CPU,
                                      precision=precision)
        ok, checks = check.judge(check.numbers(low, ref), BAGS_LIMITS)
        assert not ok and all(math.isfinite(c["value"])
                              for c in checks.values()), checks
