"""Per-field scalers; parity with the reference's feature/scalers.go.

The port's own copy of goctr_tpu/features/scalers.py (numpy only).

Each scaler exposes the reference's scalar fit/transform contract plus a
vectorized `transform_batch` (NumPy) and jit-friendly parameters, so the same
fitted object drives both host-side sample assembly and on-device pipelines.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np


class Identity:
    """scalers.go:9-17."""

    def fit(self, values: Sequence[float]) -> "Identity":
        return self

    def transform(self, v: float) -> float:
        return v

    def transform_batch(self, v) -> np.ndarray:
        return np.asarray(v, dtype=np.float32)


class MinMaxScaler:
    """Clamped [0,1] rescale; scalers.go:20-51 (clamps outside fit range,
    returns 0 when min==max)."""

    def __init__(self, min: float = 0.0, max: float = 0.0):
        self.min = min
        self.max = max

    def fit(self, values: Sequence[float]) -> "MinMaxScaler":
        values = np.asarray(values, dtype=np.float64)
        if values.size:
            self.min = float(values.min())
            self.max = float(values.max())
        return self

    def transform(self, v: float) -> float:
        if self.min == self.max:
            return 0.0
        if v < self.min:
            return 0.0
        if v > self.max:
            return 1.0
        return (v - self.min) / (self.max - self.min)

    def transform_batch(self, v) -> np.ndarray:
        v = np.asarray(v, dtype=np.float32)
        if self.min == self.max:
            return np.zeros_like(v)
        return np.clip((v - self.min) / (self.max - self.min), 0.0, 1.0)


class MaxAbsScaler:
    """Clamped [-1,1] rescale; scalers.go:54-86. Fit quirk preserved: Max is
    seeded with the first element *signed* then only |v|>Max replaces it."""

    def __init__(self, max: float = 0.0):
        self.max = max

    def fit(self, values: Sequence[float]) -> "MaxAbsScaler":
        for i, v in enumerate(np.asarray(values, dtype=np.float64)):
            if i == 0:
                self.max = float(v)
            if abs(v) > self.max:
                self.max = float(abs(v))
        return self

    def transform(self, v: float) -> float:
        if self.max == 0:
            return 0.0
        m = abs(self.max)
        if v > m:
            return 1.0
        if v < -m:
            return -1.0
        return v / m

    def transform_batch(self, v) -> np.ndarray:
        v = np.asarray(v, dtype=np.float32)
        if self.max == 0:
            return np.zeros_like(v)
        m = abs(self.max)
        return np.clip(v / m, -1.0, 1.0)


class StandardScaler:
    """(v - mean)/std with the sample (n-1) std; scalers.go:89-112 +
    common.go:5-11."""

    def __init__(self, mean: float = 0.0, std: float = 0.0):
        self.mean = mean
        self.std = std

    def fit(self, values: Sequence[float]) -> "StandardScaler":
        values = np.asarray(values, dtype=np.float64)
        if values.size:
            self.mean = float(values.mean())
            self.std = float(math.sqrt(
                np.sum((values - self.mean) ** 2) / max(values.size - 1, 1)))
        return self

    def transform(self, v: float) -> float:
        # std==0 (constant/single-value fit) → 0, instead of the reference's
        # silent NaN propagation (Go float division by zero)
        if self.std == 0:
            return 0.0
        return (v - self.mean) / self.std

    def transform_batch(self, v) -> np.ndarray:
        v = np.asarray(v, dtype=np.float32)
        if self.std == 0:
            return np.zeros_like(v)
        return (v - self.mean) / self.std


class QuantileScaler:
    """Uniformize via fitted quantiles; scalers.go:115-151.

    n_quantiles defaults to 100 (shrunk to len(values) when smaller);
    transform(v) = (searchsorted_left(quantiles, v)+1)/len, capped at 1.
    """

    def __init__(self, n_quantiles: int = 100):
        self.n_quantiles = n_quantiles
        self.quantiles: np.ndarray = np.zeros(0)

    def fit(self, values: Sequence[float]) -> "QuantileScaler":
        values = np.asarray(values, dtype=np.float64)
        if values.size == 0:
            return self
        k = min(self.n_quantiles, values.size)
        s = np.sort(values)
        f = values.size / k
        idx = (np.arange(k) * f).astype(np.int64)
        self.quantiles = s[idx]
        return self

    def transform(self, v: float) -> float:
        if self.quantiles.size == 0:
            return 0.0
        i = int(np.searchsorted(self.quantiles, v, side="left"))
        if i >= self.quantiles.size:
            return 1.0
        return (i + 1) / self.quantiles.size

    def transform_batch(self, v) -> np.ndarray:
        if self.quantiles.size == 0:
            return np.zeros_like(np.asarray(v, dtype=np.float32))
        i = np.searchsorted(self.quantiles, np.asarray(v), side="left")
        return np.minimum((i + 1) / self.quantiles.size, 1.0).astype(np.float32)
