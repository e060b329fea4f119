"""chip_smoke.py phase 16 and scripts/depth_auc.py on the CPU: the draw
they train on is bench.py's bit for bit, the port's scanned trainer
learns bench.py's workload as the JAX trainer does, and the phase's bars
and controls fail when they should.

The learning comparison runs bench.py `--smoke`'s configuration (20,000
rows + 4,000 held out, vocab 10,000, T 8, U 8, C 4, tower 64-32 relu in
bf16, batch 4,096, 3 epochs, fused split update, xla compaction, no
compact_cap, table adagrad lr 2.0, adam lr 1e-3, shuffled) through both
packages at trainer seeds 0-4. Their random streams differ (initial
parameters, shuffles), so single runs are not comparable: around the
loss's drop from its 0.67 plateau the seed decides more than the
package. The means over five seeds are: the port's must reach JAX's less
SMOKE_MARGIN (0.7664 against 0.7636 when written), and each must clear
SMOKE_FLOOR. The control trains the port on permuted training labels,
whose held-out AUC must fall to chance within CONTROL_ATOL: the bar can
fail.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import chip_smoke as cs  # noqa: E402
from goctr_tpu.models.trainer import TrainerConfig as JaxConfig  # noqa: E402
from goctr_tpu.parallel.scanned import (  # noqa: E402
    TableOptConfig as JaxTopt, train_sparse_scanned as jax_train)
from goctr_tpu.parallel.sparse_ctr import SparseCTR as JaxSparseCTR  # noqa
from goctr_tpu.parallel.sparse_trainer import (  # noqa: E402
    SparseSample as JaxSample)
from goctr_tpu_torch.core.metrics import roc_auc_score  # noqa: E402

# bench.py --smoke (:129-133, :175-203)
SMOKE_ROWS, SMOKE_EVAL, SMOKE_BATCH, SMOKE_EPOCHS = 20_000, 4_000, 4096, 3
SMOKE_CFG = dict(item_vocab=10_000, emb_dim=64, u_profile_dim=8, ctx_dim=4,
                 behavior_len=8, hidden=(64, 32), activation="relu")
SEEDS = range(5)
SMOKE_MARGIN = 0.03
SMOKE_FLOOR = 0.70
CONTROL_ATOL = 0.05
FIELDS = ("user_profile", "behavior_ids", "item_ids", "ctx", "labels")


@pytest.mark.parametrize("n,vocab,t,u,c", [
    (4_000, 10_000, 8, 8, 4),
    (2_000, 100_000_000, 32, 48, 16),
], ids=["smoke-widths", "100M"])
def test_draw_is_bench_py(n, vocab, t, u, c):
    """make_workload's arrays equal bench.py's bit for bit, and
    split_workload splits them as bench.py does (the first rows train,
    the last n_eval are held out)."""
    want, w_uids, w_oracle = bench.make_workload(n, vocab, t, u, c)
    got, g_uids, g_oracle = cs.make_workload.__wrapped__(n, vocab, t, u, c)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(g_uids, w_uids)
    assert np.array_equal(g_oracle, w_oracle)
    n_eval = n // 4
    tr, ev, ev_uids, ev_oracle = cs.split_workload(n - n_eval, vocab, t, u,
                                                   c, eval_rows=n_eval)
    for f in FIELDS:
        assert np.array_equal(getattr(tr, f), getattr(want, f)[:n - n_eval])
        assert np.array_equal(getattr(ev, f), getattr(want, f)[n - n_eval:])
    assert np.array_equal(ev_uids, w_uids[n - n_eval:])
    assert np.array_equal(ev_oracle, w_oracle[n - n_eval:])


def _jax_smoke_auc(seed: int) -> float:
    """bench.py --smoke's run in the JAX package at trainer seed `seed`,
    its held-out AUC by numpy."""
    full, _, _ = bench.make_workload(SMOKE_ROWS + SMOKE_EVAL, 10_000, 8, 8,
                                     4)

    def rows(sl):
        return JaxSample(*(getattr(full, f)[sl] for f in FIELDS))

    ev = rows(slice(SMOKE_ROWS, None))
    model = JaxSparseCTR(**SMOKE_CFG, compute_dtype=jnp.bfloat16)
    r = jax_train(model, rows(slice(None, SMOKE_ROWS)),
                  JaxConfig(batch_size=SMOKE_BATCH, epochs=SMOKE_EPOCHS,
                            early_stop=0, lr=1e-3, shuffle=True, seed=seed),
                  JaxTopt(kind="adagrad", lr=2.0, update_mode="fused",
                          rmw_impl="split", compact_impl="xla",
                          compact_cap=0))
    return roc_auc_score(np.asarray(ev.labels), r.predict(ev))


@pytest.fixture(scope="module")
def smoke_runs():
    """Held-out AUCs of both packages at SEEDS, and the port's on permuted
    training labels (seed 0)."""
    torch.set_grad_enabled(False)
    cpu = torch.device("cpu")
    draw = cs.split_workload(SMOKE_ROWS, 10_000, 8, 8, 4,
                             eval_rows=SMOKE_EVAL)

    def port(seed, d=draw):
        return cs.depth_run(torch, cpu, SMOKE_CFG, d, SMOKE_BATCH,
                            SMOKE_EPOCHS, seed=seed, compact_cap=0)

    try:
        runs = [port(s) for s in SEEDS]
        train = draw[0]
        permuted = dataclasses.replace(
            train, labels=np.random.default_rng(7).permutation(train.labels))
        control = port(0, (permuted,) + draw[1:])
    finally:
        torch.set_grad_enabled(True)
    return {"port": [r["eval_auc"] for r in runs],
            "jax": [_jax_smoke_auc(s) for s in SEEDS],
            "port_runs": runs, "control": control}


def test_port_learns_bench_workload_as_jax(smoke_runs):
    port, jax_ = np.mean(smoke_runs["port"]), np.mean(smoke_runs["jax"])
    assert port >= jax_ - SMOKE_MARGIN, smoke_runs
    assert port > SMOKE_FLOOR and jax_ > SMOKE_FLOOR, smoke_runs


def test_permuted_training_labels_read_chance(smoke_runs):
    assert abs(smoke_runs["control"]["eval_auc"] - 0.5) <= CONTROL_ATOL, \
        smoke_runs["control"]


def test_depth_run_readings(smoke_runs):
    """depth_run's readings: bench.py's shapes and steps, a ceiling of
    the draw, device metrics equal to numpy, the held-out control at
    chance, a falling loss and no overflow."""
    for r in smoke_runs["port_runs"]:
        assert (r["rows"], r["eval_rows"], r["steps_per_epoch"],
                r["pad_rows"], r["compact_cap"]) == (
            SMOKE_ROWS, SMOKE_EVAL, 5, 5 * SMOKE_BATCH - SMOKE_ROWS, 0)
        assert len(r["loss_curve"]) == len(r["epoch_s"]) == SMOKE_EPOCHS
        assert r["loss_curve"][-1] < r["loss_curve"][0]
        assert r["metric_err"] <= cs.METRIC_ATOL
        assert abs(r["control_auc"] - 0.5) <= cs.DEPTH_CONTROL_ATOL
        assert r["eval_auc"] < r["eval_auc_ceiling"] < 1.0
        assert r["overflow"] == 0 and r["peak_gb"] is None


def _reading(**change):
    """A phase-16 headline reading that meets every bar."""
    ev = {"eval_auc": 0.84, "eval_gauc": 0.84, "eval_auc_ceiling": 0.873359,
          "control_auc": 0.501, "loss_curve": [0.69, 0.5, 0.33],
          "launches": {k: 0 for k in cs.DEPTH_IDLE}}
    ev["launches"].update({k: 308 for k in cs.DEPTH_LAUNCHED})
    ev.update(change)
    return ev


@pytest.mark.parametrize("change,fails", [
    ({}, False),
    ({"eval_auc": 0.8341}, True),
    ({"eval_gauc": 0.8342}, True),
    ({"eval_auc_ceiling": 0.8741}, True),
    ({"control_auc": 0.521}, True),
    ({"loss_curve": [0.69, float("nan")]}, True),
    ({"launches": dict(_reading()["launches"], din_attention_pool_bwd=0)},
     True),
    ({"launches": dict(_reading()["launches"], apply_row_updates=1)}, True),
], ids=["met", "auc", "gauc", "ceiling", "control", "loss", "K2b idle",
        "K5 launched"])
def test_check_depth_fails_each_missed_bar(change, fails):
    if fails:
        with pytest.raises(RuntimeError, match="depth headline"):
            cs.check_depth("headline", _reading(**change))
    else:
        cs.check_depth("headline", _reading(**change))


def test_baseline5_bar_is_jax_reading_less_margin():
    """The bars are JAX's readings of the same draws less 0.01, and the
    ceilings are bench.py's."""
    assert cs.DEPTH_BARS == {
        "headline": {"eval_auc": round(0.8442 - 0.01, 4),
                     "eval_gauc": round(0.8443 - 0.01, 4)},
        "baseline5": {"eval_auc": round(0.7925 - 0.01, 4)}}
    assert cs.DEPTH_CEILING == {"headline": (0.8734, 4),
                                "baseline5": (0.872, 3)}
    ev = _reading(eval_auc=0.7826, eval_auc_ceiling=0.872180)
    del ev["eval_gauc"]
    cs.check_depth("baseline5", ev)
    with pytest.raises(RuntimeError, match="below the bar"):
        cs.check_depth("baseline5", dict(ev, eval_auc=0.7824))


def test_depth_auc_script_needs_a_card():
    """Without a card the script exits nonzero and prints no result."""
    p = subprocess.run([sys.executable, str(ROOT / "scripts/depth_auc.py"),
                        "--rows=100"], capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA device" in p.stderr
