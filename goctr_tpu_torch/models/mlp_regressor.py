"""sklearn-style MLPRegressor (port of goctr_tpu/models/mlp_regressor.py;
the reference's multilayer_perceptron.go: the classifier's engine with an
identity output and the squared loss).

As in the JAX package, `fit` makes no early-stopping split and `predict`
does not apply `batch_normalize`'s scaling (a reference fault the port
keeps, for parity).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from goctr_tpu_torch.core.metrics import r2_score
from goctr_tpu_torch.models.mlp_classifier import MLPClassifier


class MLPRegressor(MLPClassifier):

    def _loss(self, params, x, y, wmask, n_total):
        pred = self._forward(params, x)
        se = torch.sum((pred - y) ** 2, dim=-1)
        data = 0.5 * torch.sum(se * wmask) / torch.clamp(
            torch.sum(wmask), min=1.0)
        l2 = sum(torch.sum(w * w) for w in params["w"])
        return data + self.alpha * l2 / (2.0 * n_total)

    def fit(self, X: np.ndarray, y: np.ndarray, *,
            init: Optional[dict] = None) -> "MLPRegressor":
        """Train from `init` ({"w": [...], "b": [...]}) or init_params."""
        X = np.asarray(X, dtype=np.float32)
        y = np.asarray(y, dtype=np.float32)
        if y.ndim == 1:
            y = y[:, None]
        self._multiclass = False
        self.out_activation_ = "identity"
        self._n_outputs = y.shape[1]
        return self._fit_from(init, X, y)

    def predict(self, X: np.ndarray) -> np.ndarray:
        out = self._logits(X, scale=False).cpu().numpy()
        return out[:, 0] if out.shape[1] == 1 else out

    def score(self, X, y) -> float:
        """R² (sklearn regressor convention)."""
        pred = self.predict(X)
        return r2_score(np.asarray(y, dtype=np.float64).ravel(),
                        np.asarray(pred, dtype=np.float64).ravel())
