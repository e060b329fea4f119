"""The port's sklearn-style preprocessing suite
(goctr_tpu_torch/features/preprocessing/) against the JAX package's, on
the CPU. Both are host NumPy / SciPy, so each case runs the same calls on
the same numpy inputs through both packages and the results (outputs,
fitted state, inverse transforms, raised errors) must be equal exactly;
the cases are tests/test_preprocessing.py's, whose sklearn oracles the
port is held to as well, at that file's tolerances.
"""
import numpy as np
import pytest
import sklearn.preprocessing as skp

import goctr_tpu.features.preprocessing as JP
import goctr_tpu_torch.features.preprocessing as PP

SEED = 11


def _X(n=60, d=4):
    return np.random.default_rng(SEED).random((n, d)) * 10 - 3


def _same(got, want, path="result"):
    """Equal exactly, recursively (arrays by value, dtype and shape;
    objects by their state)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif hasattr(want, "__dict__"):      # a fitted part: its state
        assert type(got).__name__ == type(want).__name__, path
        _same(_state(got), _state(want), f"{path}.")
    else:
        assert got == want or (got != got and want != want), (path, got,
                                                               want)


def _state(obj):
    return {k: v for k, v in vars(obj).items() if not callable(v)}


def _fit_case(make, X=None, inverse=True):
    """fit_transform, the fitted state, transform of other rows and the
    inverse transform, where the transformer has one."""
    def case(P):
        x = _X() if X is None else X()
        t = make(P)
        out = t.fit_transform(x)
        res = dict(out=out, state=_state(t), other=t.transform(x[::3] * 1.5))
        if inverse and hasattr(t, "inverse_transform"):
            res["inv"] = t.inverse_transform(out)
        return res
    return case


def case_standard_partial(P):
    x = _X()
    s = P.StandardScaler()
    for part in (x[:20], x[20:45], x[45:]):
        s.partial_fit(part)
    return dict(state=_state(s), out=s.transform(x))


def case_incremental(P):
    x = np.random.default_rng(SEED).random((100, 3))
    inc = P.IncrementalMeanVar(3)
    for chunk in np.array_split(x, 7):
        inc.update(chunk)
    return dict(mean=inc.mean, var=inc.var, state=_state(inc))


def case_shuffler(P):
    x = np.random.default_rng(SEED).random((30, 2))
    return P.Shuffler(1).fit_transform(x, np.arange(30))


def case_kernel_centerer(P):
    a = np.random.default_rng(SEED).random((20, 6))
    k = a @ a.T
    t = P.KernelCenterer()
    return dict(out=t.fit_transform(k), other=t.transform(k[:5] * 2),
                state=_state(t))


def case_label_encoder(P):
    y = ["b", "a", "c", "a"]
    le = P.LabelEncoder().fit(y)
    return dict(t=le.transform(y), inv=le.inverse_transform([2, 1]),
                state=_state(le), ft=P.LabelEncoder().fit_transform(
                    [3, 1, 3, 2]))


def case_label_binarizer(P):
    lb = P.LabelBinarizer().fit([0, 1, 1, 0])
    out = lb.transform([1, 0])
    lb3 = P.LabelBinarizer().fit([0, 1, 2])
    o3 = lb3.transform([2, 0])
    return dict(out=out, inv=lb.inverse_transform(out), o3=o3,
                inv3=lb3.inverse_transform(o3), state=_state(lb3))


def case_multilabel(P):
    y = [("a", "b"), ("b",), (), ("c", "a")]
    m = P.MultiLabelBinarizer()
    out = m.fit_transform(y)
    return dict(out=out, inv=m.inverse_transform(out), state=_state(m))


def case_onehot_matrix(P):
    x = np.array([["a", "x"], ["b", "x"], ["a", "y"], ["c", "z"]])
    enc = P.OneHotEncoder().fit(x)
    out = enc.transform(x)
    return dict(out=out, inv=enc.inverse_transform(out),
                unk=enc.transform(np.array([["q", "x"]])))


def case_pca(P):
    x = _X()
    p = P.PCA(2).fit(x)
    y = p.transform(x)
    return dict(y=y, inv=p.inverse_transform(y), state=_state(p))


def case_imputer(P):
    x = np.array([[1.0, np.nan], [3.0, 4.0], [np.nan, 6.0], [2.0, 8.0]])
    res = {}
    for strat in ("mean", "median", "most_frequent"):
        t = P.Imputer(strat)
        res[strat] = (t.fit_transform(x), _state(t))
    return res


def case_function(P):
    x = np.abs(_X())
    ft = P.FunctionTransformer(np.log1p, np.expm1)
    out = ft.fit_transform(x)
    return dict(out=out, inv=ft.inverse_transform(out),
                ident=P.FunctionTransformer().fit_transform(x))


def _positive():
    return np.random.default_rng(SEED).random((80, 3)) * 5 + 0.1


CASES = {
    "minmax": _fit_case(lambda P: P.MinMaxScaler()),
    "minmax_range": _fit_case(lambda P: P.MinMaxScaler((-1, 2))),
    "standard": _fit_case(lambda P: P.StandardScaler()),
    "standard_partial": case_standard_partial,
    "robust": _fit_case(lambda P: P.RobustScaler()),
    "maxabs": _fit_case(lambda P: P.MaxAbsScaler()),
    "normalizer_l1": _fit_case(lambda P: P.Normalizer("l1")),
    "normalizer_l2": _fit_case(lambda P: P.Normalizer("l2")),
    "normalizer_max": _fit_case(lambda P: P.Normalizer("max")),
    "binarizer": _fit_case(lambda P: P.Binarizer(1.0)),
    "poly2": _fit_case(lambda P: P.PolynomialFeatures(2)),
    "poly2_interaction": _fit_case(
        lambda P: P.PolynomialFeatures(2, interaction_only=True)),
    "poly3": _fit_case(lambda P: P.PolynomialFeatures(3), X=lambda: _X(
        20, 3)),
    "quantile": _fit_case(lambda P: P.QuantileTransformer(n_quantiles=50)),
    "yeo_johnson": _fit_case(lambda P: P.PowerTransformer()),
    "box_cox": _fit_case(lambda P: P.PowerTransformer(method="box-cox"),
                         X=_positive),
    "kbins": _fit_case(lambda P: P.KBinsDiscretizer(4)),
    "incremental": case_incremental,
    "shuffler": case_shuffler,
    "kernel_centerer": case_kernel_centerer,
    "label_encoder": case_label_encoder,
    "label_binarizer": case_label_binarizer,
    "multilabel": case_multilabel,
    "onehot_matrix": case_onehot_matrix,
    "pca": case_pca,
    "imputer": case_imputer,
    "function": case_function,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocessing_equals_jax(case):
    _same(CASES[case](PP), CASES[case](JP))


@pytest.mark.parametrize("call", [
    lambda P: P.LabelEncoder().fit(["a"]).transform(["zz"]),
    lambda P: P.PowerTransformer(method="box-cox").fit(
        np.array([[-1.0], [2.0]])),
])
def test_errors_equal_jax(call):
    with pytest.raises(ValueError) as want:
        call(JP)
    with pytest.raises(ValueError) as got:
        call(PP)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,sk,atol", [
    ("MinMaxScaler", skp.MinMaxScaler(), 1e-12),
    ("StandardScaler", skp.StandardScaler(), 1e-10),
    ("RobustScaler", skp.RobustScaler(), 1e-10),
    ("MaxAbsScaler", skp.MaxAbsScaler(), 1e-12),
])
def test_scalers_match_sklearn(name, sk, atol):
    """tests/test_preprocessing.py's sklearn oracles, on the port."""
    x = _X()
    np.testing.assert_allclose(getattr(PP, name)().fit_transform(x),
                               sk.fit_transform(x), atol=atol)


def test_power_and_quantile_match_sklearn():
    x = _X()
    p, sk = PP.PowerTransformer().fit(x), skp.PowerTransformer().fit(x)
    np.testing.assert_allclose(p.lambdas_, sk.lambdas_, atol=0.05)
    q = PP.QuantileTransformer(n_quantiles=50).fit_transform(x)
    np.testing.assert_allclose(
        q, skp.QuantileTransformer(n_quantiles=50).fit_transform(x),
        atol=0.05)


def test_package_exports_the_jax_names():
    names = [n for n in dir(JP) if not n.startswith("_")
             and n not in ("data", "label", "extras")]
    assert len(names) == 20
    for n in names:
        assert getattr(PP, n).__module__.startswith("goctr_tpu_torch."), n
