"""Quantile-strategy discretizer; parity with
the reference's feature/discretization.go:6-24 (bin ids are 1-based, values
above the last fitted quantile map to n_bins+1).

The port's own copy of goctr_tpu/features/discretization.py (numpy only).
"""
from __future__ import annotations

import numpy as np

from goctr_tpu_torch.features.scalers import QuantileScaler


class KBinsDiscretizer(QuantileScaler):

    def transform(self, v: float) -> float:  # type: ignore[override]
        if self.quantiles.size == 0:
            return 0.0
        i = int(np.searchsorted(self.quantiles, v, side="left"))
        if i >= self.quantiles.size:
            return float(self.quantiles.size) + 1.0
        return float(i) + 1.0

    def transform_batch(self, v) -> np.ndarray:  # type: ignore[override]
        if self.quantiles.size == 0:
            return np.zeros_like(np.asarray(v, dtype=np.float32))
        i = np.searchsorted(self.quantiles, np.asarray(v), side="left")
        out = (i + 1).astype(np.float32)
        out[i >= self.quantiles.size] = self.quantiles.size + 1.0
        return out
