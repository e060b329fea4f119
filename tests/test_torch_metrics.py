"""goctr_tpu_torch.core.metrics against goctr_tpu.core.metrics.

The host functions are numpy copies: they must return what the JAX
package's return, bit for bit, on the same inputs. The device metrics
(`roc_auc_device`, `gauc_device`) accumulate ranks and rank sums in
float64, so against the numpy versions (`roc_auc_score`, `gauc_np`, also
float64) they agree to float64 rounding of sums of ≤ 2,000 terms:
atol 1e-12. Against JAX's `roc_auc_jit` / `gauc_jit`, which form ranks
and sums in float32 (exact integers and half-integers here, as every
partial sum stays below 2^24) and divide in float32: atol 1e-6.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from goctr_tpu.core import metrics as jm
from goctr_tpu_torch.core import metrics as tm

F64_ATOL = 1e-12
F32_ATOL = 1e-6


def _binary(n, seed=0, ties=False, p=0.4):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < p).astype(np.float32)
    s = (0.6 * y + rng.random(n)).astype(np.float32)
    if ties:
        s = np.round(s, 2).astype(np.float32)
    return y, s


def _host_calls(y, s, yp):
    groups = np.random.default_rng(7).integers(0, 9, y.size)
    return {
        "roc_auc_score": lambda m: m.roc_auc_score(y, s),
        "roc_curve": lambda m: m.roc_curve(y, s),
        "auc": lambda m: m.auc(np.linspace(0, 1, 9), np.linspace(0, 1, 9)
                               ** 2),
        "average_precision_score": lambda m: m.average_precision_score(y, s),
        "precision_recall_curve": lambda m: m.precision_recall_curve(y, s),
        "gauc": lambda m: m.gauc(y, s, groups),
        "gauc_np pos": lambda m: m.gauc_np(y, s, groups, weight="pos"),
        "gauc_np uniform": lambda m: m.gauc_np(y, s, groups,
                                               weight="uniform"),
        "accuracy_score": lambda m: m.accuracy_score(y, yp),
        "precision_score": lambda m: m.precision_score(y, yp),
        "recall_score micro": lambda m: m.recall_score(y, yp, "micro"),
        "f1_score weighted": lambda m: m.f1_score(y, yp, "weighted"),
        "fbeta_score binary": lambda m: m.fbeta_score(y, yp, 2.0, "binary"),
        "confusion_matrix": lambda m: m.confusion_matrix(y, yp),
        "log_loss": lambda m: m.log_loss(y, s.clip(0, 1)),
        "r2_score": lambda m: m.r2_score(y, s),
        "mean_squared_error": lambda m: m.mean_squared_error(y, s),
        "mean_absolute_error": lambda m: m.mean_absolute_error(y, s),
    }


HOST = sorted(_host_calls(*_binary(4), np.zeros(4)))


@pytest.mark.parametrize("name", HOST)
def test_host_metric_equals_jax(name):
    y, s = _binary(600, seed=1, ties=True)
    yp = (s > 0.7).astype(np.float32)
    want = _host_calls(y, s, yp)[name](jm)
    got = _host_calls(y, s, yp)[name](tm)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)


def test_all_names_ported():
    """Every name of JAX's __all__, with roc_auc_jit / gauc_jit as the
    device functions."""
    rename = {"roc_auc_jit": "roc_auc_device", "gauc_jit": "gauc_device"}
    assert sorted(rename.get(n, n) for n in jm.__all__) == sorted(tm.__all__)
    for n in tm.__all__:
        assert callable(getattr(tm, n))


def _auc_inputs(case):
    if case == "continuous":
        return _binary(1500, seed=2)
    if case == "ties":                     # scores on a 0.01 grid
        return _binary(2000, seed=3, ties=True)
    if case == "all tied":
        y, _ = _binary(300, seed=4)
        return y, np.full(300, 0.5, np.float32)
    if case == "one class":
        return np.ones(50, np.float32), _binary(50, seed=5)[1]
    if case == "two rows":
        return np.array([0, 1], np.float32), np.array([0.3, 0.2], np.float32)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["continuous", "ties", "all tied",
                                  "one class", "two rows"])
def test_roc_auc_device_matches_jax_and_numpy(case):
    y, s = _auc_inputs(case)
    got = tm.roc_auc_device(torch.from_numpy(s), torch.from_numpy(y))
    assert got.dtype == torch.float64 and got.dim() == 0
    want_jax = float(jm.roc_auc_jit(jnp.asarray(s), jnp.asarray(y)))
    if case == "one class":
        assert np.isnan(float(got)) and np.isnan(want_jax)
        assert np.isnan(tm.roc_auc_score(y, s))
        return
    assert abs(float(got) - tm.roc_auc_score(y, s)) <= F64_ATOL
    assert abs(float(got) - want_jax) <= F32_ATOL


def _gauc_inputs(case):
    rng = np.random.default_rng(11)
    n = 2000
    y, s = _binary(n, seed=12, ties=True)
    if case == "groups with ties":
        g = rng.integers(0, 40, n)
    elif case == "one-class groups":
        g = rng.integers(0, 60, n)
        y[g % 3 == 0] = 1.0                 # a third of the groups all pos
        y[g % 3 == 1] = np.where(g[g % 3 == 1] % 2 == 0, y[g % 3 == 1], 0.0)
    elif case == "single group":
        g = np.full(n, 7)
    elif case == "all one-class":
        g = rng.integers(0, 30, n)
        y = (g % 2).astype(np.float32)
    elif case == "sparse ids":               # ids far apart, negative too
        g = rng.choice(np.array([-5, 3, 10**6, 2**30]), n)
    else:
        raise ValueError(case)
    return y, s, g.astype(np.int64)


@pytest.mark.parametrize("case", ["groups with ties", "one-class groups",
                                  "single group", "all one-class",
                                  "sparse ids"])
def test_gauc_device_matches_jax_and_numpy(case):
    y, s, g = _gauc_inputs(case)
    got = tm.gauc_device(torch.from_numpy(s), torch.from_numpy(y),
                         torch.from_numpy(g))
    assert got.dtype == torch.float64 and got.dim() == 0
    want_jax = float(jm.gauc_jit(jnp.asarray(s), jnp.asarray(y),
                                 jnp.asarray(g.astype(np.int32))))
    assert abs(float(got) - want_jax) <= F32_ATOL
    want_np = tm.gauc_np(y, s, g)
    if case == "all one-class":
        # no group holds both classes: numpy says NaN, JAX and the port 0
        assert np.isnan(want_np) and float(got) == 0.0
    else:
        assert abs(float(got) - want_np) <= F64_ATOL


def test_device_metrics_stay_on_device_and_take_integer_scores():
    """0-d results on the input's device; integer scores rank as their
    values."""
    y, s = _binary(500, seed=13, ties=True)
    si = torch.from_numpy((s * 100).round().astype(np.int64))
    a = tm.roc_auc_device(si, torch.from_numpy(y))
    assert a.device == si.device and a.dtype == torch.float64
    assert abs(float(a) - tm.roc_auc_score(y, s)) <= F64_ATOL
    g = torch.from_numpy(np.arange(500) % 5)
    assert abs(float(tm.gauc_device(si, torch.from_numpy(y), g))
               - tm.gauc_np(y, s, np.arange(500) % 5)) <= F64_ATOL


@settings(max_examples=25, deadline=None, database=None)
@given(st.integers(2, 120), st.integers(1, 6), st.integers(0, 2**31 - 1))
def test_gauc_device_equals_numpy_on_random_draws(n, n_groups, seed):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.5).astype(np.float32)
    s = rng.integers(0, 5, n).astype(np.float32)    # heavy ties
    g = rng.integers(0, n_groups, n)
    got = float(tm.gauc_device(torch.from_numpy(s), torch.from_numpy(y),
                               torch.from_numpy(g)))
    want = tm.gauc_np(y, s, g)
    if np.isnan(want):
        assert got == 0.0
    else:
        assert abs(got - want) <= F64_ATOL
    auc = float(tm.roc_auc_device(torch.from_numpy(s), torch.from_numpy(y)))
    want_auc = tm.roc_auc_score(y, s)
    assert (np.isnan(auc) and np.isnan(want_auc)) or abs(
        auc - want_auc) <= F64_ATOL
