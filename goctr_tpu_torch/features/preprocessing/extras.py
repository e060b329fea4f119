"""Remaining sklearn-port transformers: OneHotEncoder (matrix,
data.go:681-785), KBinsDiscretizer (discretization.go:16), PCA (pca.go:11),
Imputer (imputation.go:14), FunctionTransformer (functiontransformer.go:9).

The port's own copy of goctr_tpu/features/preprocessing/extras.py (numpy only).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np


class OneHotEncoder:
    """Column-wise categorical → one-hot blocks (data.go:681-785)."""

    def fit(self, X, y=None):
        X = np.asarray(X)
        self.categories_ = [np.unique(X[:, j]) for j in range(X.shape[1])]
        return self

    def transform(self, X):
        X = np.asarray(X)
        blocks = []
        for j, cats in enumerate(self.categories_):
            block = np.zeros((X.shape[0], cats.size))
            idx = np.searchsorted(cats, X[:, j])
            idx = np.clip(idx, 0, cats.size - 1)
            hit = cats[idx] == X[:, j]
            block[np.nonzero(hit)[0], idx[hit]] = 1.0
            blocks.append(block)
        return np.concatenate(blocks, axis=1)

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)

    def inverse_transform(self, Y):
        Y = np.asarray(Y)
        cols = []
        start = 0
        for cats in self.categories_:
            block = Y[:, start:start + cats.size]
            cols.append(cats[np.argmax(block, axis=1)])
            start += cats.size
        return np.stack(cols, axis=1)


class KBinsDiscretizer:
    """Quantile-strategy binning to ordinal codes (discretization.go:16)."""

    def __init__(self, n_bins: int = 5, encode: str = "ordinal"):
        self.n_bins = n_bins
        self.encode = encode

    def fit(self, X, y=None):
        X = np.asarray(X, dtype=np.float64)
        qs = np.linspace(0, 100, self.n_bins + 1)
        self.bin_edges_ = [np.percentile(X[:, j], qs)
                           for j in range(X.shape[1])]
        return self

    def transform(self, X):
        X = np.asarray(X, dtype=np.float64)
        out = np.empty_like(X)
        for j, edges in enumerate(self.bin_edges_):
            out[:, j] = np.clip(
                np.searchsorted(edges[1:-1], X[:, j], side="right"),
                0, self.n_bins - 1)
        if self.encode == "onehot":
            blocks = []
            for j in range(X.shape[1]):
                b = np.zeros((X.shape[0], self.n_bins))
                b[np.arange(X.shape[0]), out[:, j].astype(int)] = 1.0
                blocks.append(b)
            return np.concatenate(blocks, axis=1)
        return out

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)


class PCA:
    """SVD principal components (pca.go:11)."""

    def __init__(self, n_components: Optional[int] = None):
        self.n_components = n_components

    def fit(self, X, y=None):
        X = np.asarray(X, dtype=np.float64)
        self.mean_ = X.mean(axis=0)
        Xc = X - self.mean_
        u, s, vt = np.linalg.svd(Xc, full_matrices=False)
        k = self.n_components or min(X.shape)
        self.components_ = vt[:k]
        self.singular_values_ = s[:k]
        var = (s ** 2) / (X.shape[0] - 1)
        self.explained_variance_ = var[:k]
        self.explained_variance_ratio_ = var[:k] / var.sum()
        return self

    def transform(self, X):
        return (np.asarray(X, dtype=np.float64) - self.mean_) @ \
            self.components_.T

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)

    def inverse_transform(self, Y):
        return np.asarray(Y) @ self.components_ + self.mean_


class Imputer:
    """NaN fill with mean/median/most_frequent (imputation.go:14)."""

    def __init__(self, strategy: str = "mean"):
        self.strategy = strategy

    def fit(self, X, y=None):
        X = np.asarray(X, dtype=np.float64)
        stats = np.empty(X.shape[1])
        for j in range(X.shape[1]):
            col = X[:, j]
            valid = col[~np.isnan(col)]
            if valid.size == 0:
                stats[j] = 0.0
            elif self.strategy == "median":
                stats[j] = np.median(valid)
            elif self.strategy == "most_frequent":
                vals, counts = np.unique(valid, return_counts=True)
                stats[j] = vals[np.argmax(counts)]
            else:
                stats[j] = valid.mean()
        self.statistics_ = stats
        return self

    def transform(self, X):
        X = np.asarray(X, dtype=np.float64).copy()
        for j in range(X.shape[1]):
            m = np.isnan(X[:, j])
            X[m, j] = self.statistics_[j]
        return X

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)


class FunctionTransformer:
    """Arbitrary fn/inverse pair (functiontransformer.go:9)."""

    def __init__(self, func: Optional[Callable] = None,
                 inverse_func: Optional[Callable] = None):
        self.func = func
        self.inverse_func = inverse_func

    def fit(self, X, y=None):
        return self

    def transform(self, X):
        return self.func(X) if self.func else np.asarray(X)

    def fit_transform(self, X, y=None):
        return self.transform(X)

    def inverse_transform(self, Y):
        return self.inverse_func(Y) if self.inverse_func else np.asarray(Y)
