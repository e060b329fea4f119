"""Matrix-level preprocessing transformers.

The port's own copy of goctr_tpu/features/preprocessing/data.py (numpy only).

Parity with the reference's sklearn-port suite
(the reference's feature/preprocessing/data.go): fit/transform/
inverse_transform over [n_samples, n_features] matrices with sklearn
semantics (each class docstring cites its data.go anchor). NumPy-based —
these run in the host data plane; the jittable per-field encoders live in
goctr_tpu_torch.features.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
from scipy import optimize as sp_optimize
from scipy import stats as sp_stats


class MinMaxScaler:
    """data.go:29-128."""

    def __init__(self, feature_range: tuple[float, float] = (0.0, 1.0)):
        self.feature_range = feature_range

    def fit(self, X, y=None):
        X = np.asarray(X, dtype=np.float64)
        lo, hi = self.feature_range
        self.data_min_ = X.min(axis=0)
        self.data_max_ = X.max(axis=0)
        rng = self.data_max_ - self.data_min_
        rng[rng == 0] = 1.0
        self.scale_ = (hi - lo) / rng
        self.min_ = lo - self.data_min_ * self.scale_
        return self

    def transform(self, X):
        return np.asarray(X, dtype=np.float64) * self.scale_ + self.min_

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)

    def inverse_transform(self, X):
        return (np.asarray(X, dtype=np.float64) - self.min_) / self.scale_


class StandardScaler:
    """data.go:131-305 (population variance, sklearn default ddof=0)."""

    def __init__(self, with_mean: bool = True, with_std: bool = True):
        self.with_mean = with_mean
        self.with_std = with_std

    def fit(self, X, y=None):
        X = np.asarray(X, dtype=np.float64)
        self.mean_ = X.mean(axis=0) if self.with_mean else \
            np.zeros(X.shape[1])
        if self.with_std:
            var = X.var(axis=0)
            self.var_ = var
            scale = np.sqrt(var)
            scale[scale == 0] = 1.0
            self.scale_ = scale
        else:
            self.var_ = None
            self.scale_ = np.ones(X.shape[1])
        return self

    def transform(self, X):
        return (np.asarray(X, dtype=np.float64) - self.mean_) / self.scale_

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)

    def inverse_transform(self, X):
        return np.asarray(X, dtype=np.float64) * self.scale_ + self.mean_

    def partial_fit(self, X, y=None):
        """Streaming fit via IncrementalMeanVar (data.go:473-538)."""
        X = np.asarray(X, dtype=np.float64)
        if not hasattr(self, "_inc"):
            self._inc = IncrementalMeanVar(X.shape[1])
        self._inc.update(X)
        self.mean_ = self._inc.mean.copy()
        self.var_ = self._inc.var.copy()
        scale = np.sqrt(self.var_)
        scale[scale == 0] = 1.0
        self.scale_ = scale
        return self


class IncrementalMeanVar:
    """Chan et al. streaming mean/variance (data.go:473-538)."""

    def __init__(self, n_features: int):
        self.mean = np.zeros(n_features)
        self.var = np.zeros(n_features)
        self.count = 0.0

    def update(self, X: np.ndarray) -> None:
        X = np.asarray(X, dtype=np.float64)
        n_new = X.shape[0]
        if n_new == 0:
            return
        new_mean = X.mean(axis=0)
        new_var = X.var(axis=0)
        if self.count == 0:
            self.mean, self.var, self.count = new_mean, new_var, float(n_new)
            return
        total = self.count + n_new
        delta = new_mean - self.mean
        m_a = self.var * self.count
        m_b = new_var * n_new
        m2 = m_a + m_b + delta ** 2 * self.count * n_new / total
        self.mean = (self.count * self.mean + n_new * new_mean) / total
        self.var = m2 / total
        self.count = total


class RobustScaler:
    """Median/IQR scaling (data.go:308-470)."""

    def __init__(self, with_centering: bool = True,
                 with_scaling: bool = True,
                 quantile_range: tuple[float, float] = (25.0, 75.0)):
        self.with_centering = with_centering
        self.with_scaling = with_scaling
        self.quantile_range = quantile_range

    def fit(self, X, y=None):
        X = np.asarray(X, dtype=np.float64)
        self.center_ = np.median(X, axis=0) if self.with_centering else \
            np.zeros(X.shape[1])
        if self.with_scaling:
            q = np.percentile(X, self.quantile_range, axis=0)
            scale = q[1] - q[0]
            scale[scale == 0] = 1.0
            self.scale_ = scale
        else:
            self.scale_ = np.ones(X.shape[1])
        return self

    def transform(self, X):
        return (np.asarray(X, dtype=np.float64) - self.center_) / self.scale_

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)

    def inverse_transform(self, X):
        return np.asarray(X, dtype=np.float64) * self.scale_ + self.center_


class MaxAbsScaler:
    """data.go:912-1000."""

    def fit(self, X, y=None):
        X = np.asarray(X, dtype=np.float64)
        scale = np.abs(X).max(axis=0)
        scale[scale == 0] = 1.0
        self.scale_ = scale
        return self

    def transform(self, X):
        return np.asarray(X, dtype=np.float64) / self.scale_

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)

    def inverse_transform(self, X):
        return np.asarray(X, dtype=np.float64) * self.scale_


class Normalizer:
    """Row-wise l1/l2/max normalization (data.go:1003-1082)."""

    def __init__(self, norm: str = "l2"):
        self.norm = norm

    def fit(self, X, y=None):
        return self

    def transform(self, X):
        X = np.asarray(X, dtype=np.float64)
        if self.norm == "l1":
            s = np.abs(X).sum(axis=1, keepdims=True)
        elif self.norm == "max":
            s = np.abs(X).max(axis=1, keepdims=True)
        else:
            s = np.sqrt((X * X).sum(axis=1, keepdims=True))
        s[s == 0] = 1.0
        return X / s

    def fit_transform(self, X, y=None):
        return self.transform(X)


class Binarizer:
    """Threshold to 0/1 (data.go:870-909)."""

    def __init__(self, threshold: float = 0.0):
        self.threshold = threshold

    def fit(self, X, y=None):
        return self

    def transform(self, X):
        return (np.asarray(X, dtype=np.float64) > self.threshold
                ).astype(np.float64)

    def fit_transform(self, X, y=None):
        return self.transform(X)


class PolynomialFeatures:
    """Degree-d polynomial expansion with sklearn's term ordering
    (data.go:541-678)."""

    def __init__(self, degree: int = 2, interaction_only: bool = False,
                 include_bias: bool = True):
        self.degree = degree
        self.interaction_only = interaction_only
        self.include_bias = include_bias

    def fit(self, X, y=None):
        import itertools
        n = np.asarray(X).shape[1]
        combos: list[tuple[int, ...]] = []
        start = 0 if self.include_bias else 1
        for d in range(start, self.degree + 1):
            if self.interaction_only:
                combos.extend(itertools.combinations(range(n), d))
            else:
                combos.extend(
                    itertools.combinations_with_replacement(range(n), d))
        self._combos = combos
        self.n_output_features_ = len(combos)
        return self

    def transform(self, X):
        X = np.asarray(X, dtype=np.float64)
        out = np.ones((X.shape[0], len(self._combos)))
        for j, combo in enumerate(self._combos):
            for i in combo:
                out[:, j] *= X[:, i]
        return out

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)


class Shuffler:
    """Row shuffler keeping X/Y aligned (data.go:788-867)."""

    def __init__(self, random_state: int = 0):
        self.random_state = random_state

    def fit_transform(self, X, Y=None):
        X = np.asarray(X)
        rng = np.random.default_rng(self.random_state)
        perm = rng.permutation(X.shape[0])
        self.perm_ = perm
        if Y is None:
            return X[perm]
        return X[perm], np.asarray(Y)[perm]


class KernelCenterer:
    """Center a kernel (Gram) matrix (data.go:1085-1144)."""

    def fit(self, K, y=None):
        K = np.asarray(K, dtype=np.float64)
        n = K.shape[0]
        self.k_fit_rows_ = K.sum(axis=0) / n
        self.k_fit_all_ = self.k_fit_rows_.sum() / n
        return self

    def transform(self, K):
        K = np.asarray(K, dtype=np.float64)
        pred_cols = (K.sum(axis=1) / self.k_fit_rows_.shape[0])[:, None]
        return K - self.k_fit_rows_ - pred_cols + self.k_fit_all_

    def fit_transform(self, K, y=None):
        return self.fit(K).transform(K)


class QuantileTransformer:
    """Map to uniform [0,1] via the empirical CDF (data.go:1147-1370)."""

    def __init__(self, n_quantiles: int = 1000,
                 output_distribution: str = "uniform"):
        self.n_quantiles = n_quantiles
        self.output_distribution = output_distribution

    def fit(self, X, y=None):
        X = np.asarray(X, dtype=np.float64)
        k = min(self.n_quantiles, X.shape[0])
        self.references_ = np.linspace(0, 1, k)
        self.quantiles_ = np.percentile(X, self.references_ * 100, axis=0)
        return self

    def transform(self, X):
        X = np.asarray(X, dtype=np.float64)
        out = np.empty_like(X)
        for j in range(X.shape[1]):
            q = self.quantiles_[:, j]
            # average forward/backward interpolation like sklearn (handles
            # repeated quantile values symmetrically)
            fwd = np.interp(X[:, j], q, self.references_)
            bwd = -np.interp(-X[:, j], -q[::-1], -self.references_[::-1])
            out[:, j] = 0.5 * (fwd + bwd)
        if self.output_distribution == "normal":
            eps = 1e-7
            out = sp_stats.norm.ppf(np.clip(out, eps, 1 - eps))
        return out

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)

    def inverse_transform(self, X):
        X = np.asarray(X, dtype=np.float64)
        if self.output_distribution == "normal":
            X = sp_stats.norm.cdf(X)
        out = np.empty_like(X)
        for j in range(X.shape[1]):
            out[:, j] = np.interp(X[:, j], self.references_,
                                  self.quantiles_[:, j])
        return out


class PowerTransformer:
    """Yeo-Johnson (default) / Box-Cox with per-feature λ by max-likelihood
    via Brent minimization (data.go:1373-1554; brentminimize.go:100-158),
    then standardization."""

    def __init__(self, method: str = "yeo-johnson", standardize: bool = True):
        self.method = method
        self.standardize = standardize

    def fit(self, X, y=None):
        X = np.asarray(X, dtype=np.float64)
        self.lambdas_ = np.array([self._optimize_lmbda(X[:, j])
                                  for j in range(X.shape[1])])
        if self.standardize:
            Xt = self._transform_raw(X)
            self._scaler = StandardScaler().fit(Xt)
        return self

    def transform(self, X):
        Xt = self._transform_raw(np.asarray(X, dtype=np.float64))
        if self.standardize:
            Xt = self._scaler.transform(Xt)
        return Xt

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)

    # ------------------------------------------------------------ internals
    def _transform_raw(self, X):
        out = np.empty_like(X)
        for j, lm in enumerate(self.lambdas_):
            out[:, j] = self._apply(X[:, j], lm)
        return out

    def _apply(self, x, lm):
        if self.method == "box-cox":
            return sp_stats.boxcox(x, lm) if False else (
                (np.power(x, lm) - 1) / lm if abs(lm) > 1e-12 else np.log(x))
        # yeo-johnson
        out = np.empty_like(x)
        pos = x >= 0
        if abs(lm) > 1e-12:
            out[pos] = (np.power(x[pos] + 1, lm) - 1) / lm
        else:
            out[pos] = np.log1p(x[pos])
        if abs(lm - 2) > 1e-12:
            out[~pos] = -(np.power(1 - x[~pos], 2 - lm) - 1) / (2 - lm)
        else:
            out[~pos] = -np.log1p(-x[~pos])
        return out

    def _neg_log_likelihood(self, lm, x):
        n = x.shape[0]
        t = self._apply(x, lm)
        var = t.var()
        if var <= 0:
            return np.inf
        ll = -0.5 * n * np.log(var)
        if self.method == "box-cox":
            ll += (lm - 1) * np.log(x).sum()
        else:
            ll += (lm - 1) * (np.sign(x) * np.log1p(np.abs(x))).sum()
        return -ll

    def _optimize_lmbda(self, x):
        if self.method == "box-cox" and np.any(x <= 0):
            raise ValueError("box-cox requires strictly positive data")
        res = sp_optimize.brent(
            lambda lm: self._neg_log_likelihood(lm, x), brack=(-2.0, 2.0))
        return float(res)
