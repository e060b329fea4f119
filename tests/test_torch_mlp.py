"""The port's sklearn-style MLPs (MLPClassifier, MLPRegressor), Neural and
full-batch solvers (optim.fullbatch_minimize: lbfgs, bfgs, cg) against
the JAX package's, on the CPU.

JAX's threefry streams cannot be reproduced in torch, so the port starts
from the JAX model's initial parameters (`MLPClassifier(max_iter=0).fit`
stores exactly them; `fit(..., init=...)`) and the stochastic runs use
shuffle=False. Neural's training shuffles with numpy in both packages, so
its whole run compares, shuffling included, once the initial weights are
carried across (`convert.neural_from_jax`).

Tolerances. Stochastic fits (adam, sgd) and cg: the same f32 arithmetic
in other orders (XLA's dots and reductions vs torch's CPU kernels) —
loss curves within rtol 1e-5, parameters and probabilities within atol
1e-6 + rtol 1e-5 (observed ≤ 2e-7). bfgs: JAX updates the inverse
Hessian as V H Vᵀ (two n³ products), the port in rank-two form, the same
function with other roundings; over 20 iterations the curves stay within
rtol 1e-4 (observed ≤ 7e-5 over 30). lbfgs: optax's zoom line search
branches on f32 comparisons, so an ulp can pick another trial step and
the difference then grows as the loss falls towards 0: the first 10
iterations within rtol 1e-5 (observed ≤ 2e-6), the rest and the final
loss within rtol 1e-2 (observed ≤ 1e-3 over 30 iterations).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from goctr_tpu.models.mlp_classifier import MLPClassifier as JMLP
from goctr_tpu.models.mlp_regressor import MLPRegressor as JReg
from goctr_tpu.models.neural import Neural as JNeural
from goctr_tpu.models.neural import NeuralConfig as JNCfg
from goctr_tpu.optim import fullbatch_minimize as jminimize

from goctr_tpu_torch.convert import mlp_from_jax, neural_from_jax
from goctr_tpu_torch.models.mlp_classifier import MLPClassifier
from goctr_tpu_torch.models.mlp_regressor import MLPRegressor
from goctr_tpu_torch.models.neural import Neural, NeuralConfig
from goctr_tpu_torch.optim.optimizers import (
    FULLBATCH_SOLVERS, LBFGS, fullbatch_minimize, make_solver, tree_leaves,
)

CPU = "cpu"
F32 = dict(atol=1e-6, rtol=1e-5)
LOSS_RTOL = 1e-5
BFGS_RTOL = 1e-4
LBFGS_TIGHT_ITERS, LBFGS_LOOSE_RTOL = 10, 1e-2


def data(n=530, seed=0, classes=2):
    """Rows with a nonlinear planted rule; labels binary, three classes
    or a regression target."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    s = X[:, 0] + X[:, 1] ** 2 - 0.5 * X[:, 2]
    if classes == 0:
        return X, (s + 0.1 * rng.normal(size=n)).astype(np.float32)
    if classes == 2:
        return X, (s > 1).astype(np.int64)
    return X, np.digitize(s, [0.0, 1.5])


def jax_init(cls, X, y, **kw):
    j0 = cls(**dict(kw, max_iter=0)).fit(X, y)
    return {"w": j0.coefs_, "b": j0.intercepts_}


def fit_both(jcls, tcls, X, y, **kw):
    """(JAX model, port model) fitted from the JAX model's init."""
    j = jcls(**kw).fit(X, y)
    t = tcls(**kw, device=CPU).fit(X, y, init=jax_init(jcls, X, y, **kw))
    return j, t


def assert_params(j, t):
    for a, b in zip(j.coefs_ + j.intercepts_, t.coefs_ + t.intercepts_):
        np.testing.assert_allclose(b, a, **F32)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.abs(a)


STOCHASTIC = {
    "adam": dict(solver="adam"),
    "sgd nesterov": dict(solver="sgd", learning_rate_init=0.05),
    "sgd momentum": dict(solver="sgd", nesterovs_momentum=False,
                         learning_rate_init=0.05),
    "sgd plain": dict(solver="sgd", momentum=0.0, learning_rate_init=0.1),
    "invscaling": dict(solver="sgd", learning_rate="invscaling",
                       learning_rate_init=0.2),
    "adaptive": dict(solver="sgd", learning_rate="adaptive",
                     n_iter_no_change=2, tol=0.05, max_iter=9),
    "early stopping": dict(early_stopping=True, validation_fraction=0.2,
                           n_iter_no_change=2, tol=0.05, max_iter=9),
    "batch_normalize": dict(batch_normalize=True),
    "weight_decay": dict(weight_decay=1e-2, alpha=1e-2),
    "tanh, batch 100": dict(activation="tanh", batch_size=100),
    "logistic, full batch": dict(activation="logistic", batch_size=1000),
}


@pytest.mark.parametrize("classes", [2, 3])
@pytest.mark.parametrize("case", list(STOCHASTIC))
def test_classifier_stochastic_matches_jax(case, classes):
    X, y = data(classes=classes)
    kw = dict(dict(hidden_layer_sizes=(9, 5), batch_size=64, max_iter=5,
                   shuffle=False), **STOCHASTIC[case])
    j, t = fit_both(JMLP, MLPClassifier, X, y, **kw)
    assert t.n_iter_ == j.n_iter_ and len(t.loss_curve_) == t.n_iter_
    assert rel(j.loss_curve_, t.loss_curve_).max() <= LOSS_RTOL
    assert_params(j, t)
    np.testing.assert_allclose(t.predict_proba(X), j.predict_proba(X), **F32)
    np.testing.assert_array_equal(t.predict(X), j.predict(X))
    assert t.out_activation_ == j.out_activation_
    np.testing.assert_array_equal(t.classes_, j.classes_)


@pytest.mark.parametrize("classes", [2, 3])
@pytest.mark.parametrize("solver", FULLBATCH_SOLVERS)
def test_classifier_fullbatch_matches_jax(solver, classes):
    X, y = data(400, seed=1, classes=classes)
    kw = dict(hidden_layer_sizes=(9,), solver=solver, max_iter=20, tol=0.0)
    j, t = fit_both(JMLP, MLPClassifier, X, y, **kw)
    assert t.n_iter_ == j.n_iter_ == 20
    r = rel(j.loss_curve_, t.loss_curve_)
    if solver == "lbfgs":
        assert r[:LBFGS_TIGHT_ITERS].max() <= LOSS_RTOL, r
        assert r.max() <= LBFGS_LOOSE_RTOL, r
    else:
        assert r.max() <= (BFGS_RTOL if solver == "bfgs" else LOSS_RTOL), r
    assert t.loss_curve_[-1] < t.loss_curve_[0]


@pytest.mark.parametrize("solver", ["adam", "sgd", "lbfgs", "bfgs", "cg"])
def test_max_iter_0_stores_the_initial_parameters(solver):
    X, y = data(200, seed=2)
    kw = dict(hidden_layer_sizes=(4,), solver=solver, max_iter=0)
    init = jax_init(JMLP, X, y, **kw)
    t = MLPClassifier(**kw, device=CPU).fit(X, y, init=init)
    for a, b in zip(init["w"] + init["b"], t.coefs_ + t.intercepts_):
        np.testing.assert_array_equal(a, b)
    assert t.loss_curve_ == [] and t.n_iter_ == 0
    # the port's own Glorot draw: the JAX bounds, from random_state
    own = MLPClassifier(**kw, device=CPU).fit(X, y)
    again = MLPClassifier(**kw, device=CPU).fit(X, y)
    for w, w2, b in zip(own.coefs_, again.coefs_, init["w"]):
        np.testing.assert_array_equal(w, w2)
        bound = np.sqrt(6.0 / sum(w.shape))
        assert w.shape == b.shape and np.abs(w).max() <= bound


@pytest.mark.parametrize("solver", ["adam", "sgd", "lbfgs", "cg"])
def test_regressor_matches_jax(solver):
    X, y = data(400, seed=3, classes=0)
    kw = dict(hidden_layer_sizes=(8, 4), solver=solver, batch_size=64,
              max_iter=6, shuffle=False, tol=0.0, learning_rate_init=0.01)
    # lbfgs's line search can take another trial step an ulp apart: its
    # predictions after 6 iterations within atol 1e-5 (observed 2.1e-6)
    tol = dict(atol=1e-5, rtol=0.0) if solver == "lbfgs" else F32
    j, t = fit_both(JReg, MLPRegressor, X, y, **kw)
    r = rel(j.loss_curve_, t.loss_curve_)
    assert r.max() <= LOSS_RTOL, r
    np.testing.assert_allclose(t.predict(X), j.predict(X), **tol)
    assert t.score(X, y) == pytest.approx(j.score(X, y), abs=1e-5)
    if solver == "adam":                # two outputs
        y2 = np.stack([y, -y], 1)
        j2, t2 = fit_both(JReg, MLPRegressor, X, y2, **kw)
        assert t2.predict(X).shape == (400, 2)
        np.testing.assert_allclose(t2.predict(X), j2.predict(X), **tol)


@pytest.mark.parametrize("solver", FULLBATCH_SOLVERS)
def test_fullbatch_solvers_solve_the_quadratic_as_jax(solver):
    """tests/test_mlp_classifier.py's quadratic f(x) = ½(x−c)ᵀA(x−c)."""
    rng = np.random.default_rng(0)
    m = rng.normal(0, 1, (6, 6))
    a = (m @ m.T + 6 * np.eye(6)).astype(np.float32)
    c = rng.normal(0, 2, 6).astype(np.float32)
    js, jc, jn = jminimize(
        solver, lambda p: 0.5 * (p["x"] - c) @ jnp.asarray(a) @ (p["x"] - c),
        {"x": jnp.zeros(6, jnp.float32)}, max_iter=200, tol=1e-10)
    at, ct = torch.from_numpy(a), torch.from_numpy(c)
    ts, tc, tn = fullbatch_minimize(
        solver, lambda p: 0.5 * (p["x"] - ct) @ at @ (p["x"] - ct),
        {"x": torch.zeros(6)}, max_iter=200, tol=1e-10)
    assert tn == jn == len(tc)
    np.testing.assert_allclose(ts["x"].numpy(), c, atol=1e-3)
    np.testing.assert_allclose(ts["x"].numpy(), np.asarray(js["x"]),
                               atol=1e-5)
    # the first steps, before the loss nears 0 (lbfgs's iteration 5 reads
    # 8e-4 of a starting 148: its relative error then grows)
    np.testing.assert_allclose(tc[:3], jc[:3], rtol=LOSS_RTOL)
    assert tc[-1] < 1e-5


def test_lbfgs_state_matches_optax_leaf_for_leaf():
    """The port's LBFGS state maps onto jax.tree.leaves of optax.lbfgs()'s
    state, in order, after each of 6 steps on a two-leaf problem."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(5, 3)).astype(np.float32)
    b = rng.normal(size=3).astype(np.float32)

    def jloss(p):
        return (jnp.sum(jnp.tanh(jnp.asarray(a) @ p["w"] + p["b"]) ** 2)
                + 0.1 * jnp.sum(p["w"] ** 2) + jnp.sum((p["b"] - 1) ** 2))

    def tloss(leaves):
        pb, pw = leaves
        return (torch.sum(torch.tanh(torch.from_numpy(a) @ pw + pb) ** 2)
                + 0.1 * torch.sum(pw ** 2) + torch.sum((pb - 1) ** 2))

    jp = {"w": jnp.asarray(b), "b": jnp.zeros(5, jnp.float32)}
    solver = optax.lbfgs()
    js = solver.init(jp)
    vg = optax.value_and_grad_from_state(jloss)

    @jax.jit
    def jstep(jp, js):
        value, grad = vg(jp, state=js)
        upd, js = solver.update(grad, js, jp, value=value, grad=grad,
                                value_fn=jloss)
        return optax.apply_updates(jp, upd), js
    tsolver = make_solver("lbfgs")
    assert isinstance(tsolver, LBFGS)
    tp = [torch.zeros(5), torch.from_numpy(b.copy())]
    ts = tsolver.init(tp)
    assert len(ts) == len(jax.tree.leaves(js)) == tsolver.n_state(2)
    for _ in range(6):
        jp, js = jstep(jp, js)
        tv, tg = tsolver.value_and_grad(tloss, tp, ts)
        tu, ts = tsolver.update(tg, ts, tp, value=tv, value_fn=tloss)
        tp = [p + u for p, u in zip(tp, tu)]
        for x, y in zip(jax.tree.leaves(js), ts):
            assert np.shape(x) == tuple(y.shape)
            assert np.asarray(x).dtype == y.numpy().dtype
            np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-5,
                                       rtol=1e-4)
    for x, y in zip(tree_leaves({"b": tp[0], "w": tp[1]}), tp):
        assert x is y
    with pytest.raises(ValueError, match="unknown full-batch solver"):
        fullbatch_minimize("newton", tloss, [torch.zeros(2)])


@pytest.mark.parametrize("cfg", [
    dict(layout=(7, 5, 1), activation="sigmoid", loss="mse"),
    dict(layout=(6, 1), activation=("tanh", "sigmoid"),
         loss="cross_entropy"),
    dict(layout=(4, 1), activation="sigmoid", bias=False, weight_std=0.3),
], ids=["mse", "ce, two activations", "no bias"])
def test_neural_training_run_matches_jax(cfg):
    """The whole run, numpy shuffling included, from JAX's weights; the
    last batch of each epoch is ragged (530 = 8 × 64 + 18)."""
    X, y = data(530, seed=5, classes=0)
    target = (y > np.median(y)).astype(np.float32)[:, None] \
        if cfg.get("loss") == "cross_entropy" else 1 / (1 + np.exp(-y[:, None]))
    jcfg = JNCfg(inputs=6, **cfg)
    jn = JNeural(jcfg, seed=0)
    tn = neural_from_jax(jn.weights, jn.biases, dataclasses.asdict(jcfg),
                         device=CPU)
    jc = jn.train(X, target, lr=0.1, epochs=3, batch_size=64, seed=7)
    tc = tn.train(X, target, lr=0.1, epochs=3, batch_size=64, seed=7)
    assert rel(jc, tc).max() <= LOSS_RTOL
    for a, b in zip(jn.weights + jn.biases, tn.weights + tn.biases):
        np.testing.assert_allclose(b, a, **F32)
    np.testing.assert_allclose(tn.predict(X[:20]), jn.predict(X[:20]), **F32)


def test_neural_marshal_round_trips_both_ways():
    cfg = NeuralConfig(inputs=6, layout=(5, 2), activation=("relu", "tanh"),
                       mode="regression", loss="mse")
    tn = Neural(cfg, seed=1, device=CPU)
    X = data(10, seed=6)[0]
    back = Neural.unmarshal(tn.marshal(), device=CPU)
    assert back.config == cfg
    np.testing.assert_array_equal(back.predict(X), tn.predict(X))
    jn = JNeural.unmarshal(tn.marshal())
    np.testing.assert_allclose(jn.predict(X), tn.predict(X), **F32)
    tn2 = Neural.unmarshal(jn.marshal(), device=CPU)
    np.testing.assert_allclose(tn2.predict(X), jn.predict(X), **F32)


@pytest.mark.parametrize("classes", [2, 3])
def test_json_interop_both_ways(classes):
    X, y = data(300, seed=7, classes=classes)
    kw = dict(hidden_layer_sizes=(6,), max_iter=3, batch_size=50,
              shuffle=False)
    j, t = fit_both(JMLP, MLPClassifier, X, y, **kw)
    from_port = JMLP.from_json(t.to_json())
    np.testing.assert_allclose(from_port.predict_proba(X),
                               t.predict_proba(X), **F32)
    from_jax = MLPClassifier.from_json(j.to_json(), device=CPU)
    np.testing.assert_allclose(from_jax.predict_proba(X),
                               j.predict_proba(X), **F32)
    assert not from_jax.batch_normalize
    conv = mlp_from_jax(j.coefs_, j.intercepts_, j.out_activation_,
                        j.classes_, device=CPU, **j.get_params())
    np.testing.assert_array_equal(conv.predict(X), j.predict(X))
    assert conv.get_params() == dict(j.get_params(), device=CPU)
    reg = JReg((5,), max_iter=2, batch_size=50).fit(X, X[:, 0])
    creg = mlp_from_jax(reg.coefs_, reg.intercepts_, reg.out_activation_,
                        device=CPU, **reg.get_params())
    assert isinstance(creg, MLPRegressor)
    np.testing.assert_allclose(creg.predict(X), reg.predict(X), **F32)


def test_batch_normalize_survives_the_json_round_trip():
    """JAX's to_json drops batch_normalize, and its model loads without
    it (a reference fault); the port writes it and reads it back."""
    rng = np.random.default_rng(8)
    X = (rng.normal(size=(300, 4)) * [1, 50, 0.01, 3]).astype(np.float32)
    y = (X[:, 0] + X[:, 1] / 50 > 0).astype(np.int64)
    t = MLPClassifier((6,), batch_normalize=True, max_iter=5,
                      device=CPU).fit(X, y)
    blob = t.to_json()
    assert json.loads(blob)["batch_normalize"] is True
    back = MLPClassifier.from_json(blob, device=CPU)
    assert back.batch_normalize
    np.testing.assert_array_equal(back.predict_proba(X), t.predict_proba(X))
    lost = JMLP.from_json(blob)
    assert not lost.batch_normalize
    assert np.abs(lost.predict_proba(X) - t.predict_proba(X)).max() > 1e-3


def test_params_and_card_refusal(monkeypatch):
    t = MLPClassifier((3,), device=CPU)
    p = t.get_params()
    assert p == dict(JMLP((3,)).get_params(), device=CPU)
    t.set_params(alpha=0.5, solver="sgd")
    assert (t.alpha, t.solver) == (0.5, "sgd")
    X, y = data(50, seed=9)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model in (MLPClassifier((3,)), MLPRegressor((3,))):
        with pytest.raises(RuntimeError, match="is_available"):
            model.fit(X, y)
    with pytest.raises(RuntimeError, match="is_available"):
        Neural(NeuralConfig(inputs=6, layout=(1,))).predict(X)
