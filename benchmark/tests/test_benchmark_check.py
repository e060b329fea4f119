"""The comparison that decides `correct`, run end to end on the CPU at a
tiny size through the port's plain kernel versions: the port agrees with
the reference; the control (the reference in float8 in the program's
place) and each planted fault come out not correct, and so does a window
whose loop skips steps that set-up's first steps never see."""
import time

import pytest
import torch

from benchmark import check, harness
from conftest import TINY_CELL, TINY_LIMITS
from goctr_tpu_torch.parallel import scanned

CPU = torch.device("cpu")


def run(bench, seed=2**31 + 11):
    line, _, _ = harness.run_cell(bench, bench.cell(TINY_CELL), seed, 0.5,
                                    False, CPU, time.perf_counter())
    return line


@pytest.mark.parametrize("seed", [1, 2**31 + 11])
def test_port_agrees_with_reference(tiny_bench, seed):
    line = run(tiny_bench, seed)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 2 * 8
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"train_examples_per_s",
                                    "peak_device_gb", "setup_s"}


def test_control_fails(tiny_bench):
    cell = tiny_bench.cell(TINY_CELL)
    _, control = cell.family.control(cell.config)
    for seed in (1, 2, 3):
        prep = harness.prepare(cell, seed, CPU)
        ref = harness.reference_first(cell, prep, seed, CPU)
        fp8 = harness.reference_first(cell, prep, seed, CPU,
                                      precision=control)
        ok, checks = check.judge(check.numbers(fp8, ref), TINY_LIMITS)
        assert not ok, checks


def _unchanged_step(model, table, solver, opt_state, b_prof, b_bids, b_iids,
                    b_ctx, b_y, b_w, topt, generator=None, acc=None):
    """A step that computes its loss and returns its state unchanged."""
    emb = scanned.gather_batch_rows(model, table, b_bids, b_iids, False,
                                    scanned.table_group(topt.update_mode,
                                                        model.emb_dim))
    loss = scanned.batch_loss(model, emb, b_prof, b_bids, b_ctx, b_y, b_w)
    return loss.detach(), torch.zeros((), dtype=torch.int32), opt_state


def _half_batch_step(model, table, solver, opt_state, b_prof, b_bids, b_iids,
                     b_ctx, b_y, b_w, topt, generator=None, acc=None):
    """The step with half of the batch left out, the mean over the rest."""
    keep = (torch.arange(b_w.shape[0]) < b_w.shape[0] // 2).float()
    return REAL_STEP(model, table, solver, opt_state, b_prof, b_bids, b_iids,
                     b_ctx, b_y, b_w * keep, topt, generator, acc)


REAL_STEP = scanned.train_step


@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch_step],
                         ids=["state_unchanged", "half_batch"])
def test_planted_fault_fails(tiny_bench, monkeypatch, fault):
    monkeypatch.setattr(scanned, "train_step", fault)
    line = run(tiny_bench)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("skips", [True, False], ids=["skips", "sound"])
def test_window_that_skips_steps_fails(tiny_bench, monkeypatch, skips):
    """With a counter of the steps that ran in place of the port's kernel
    counters (the CPU's plain versions count nothing), a window that
    trains every second step only comes out not correct, and a sound one
    correct."""
    ran, calls, in_window = [0], [0], [False]

    def step(*args, **kw):
        calls[0] += 1
        if skips and in_window[0] and calls[0] % 2:
            return _unchanged_step(*args, **kw)
        ran[0] += 1
        return REAL_STEP(*args, **kw)

    family = tiny_bench.cell(TINY_CELL).family
    real_window = family.Program.window

    def window(self, *args, **kw):
        in_window[0] = True
        try:
            return real_window(self, *args, **kw)
        finally:
            in_window[0] = False

    monkeypatch.setattr(scanned, "train_step", step)
    monkeypatch.setattr(family.Program, "window", window)
    monkeypatch.setattr(family, "launches", lambda: {"train_step": ran[0]})
    line = run(tiny_bench)
    assert line["correct"] is not skips, line["checks"]
    assert (line["checks"]["launches_off"]["value"] > 0) is skips
