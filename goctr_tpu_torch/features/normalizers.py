"""Per-sample L1/L2 normalizers; parity with the reference's
feature/samplenormalizers.go (zero vectors stay zero).

The port of goctr_tpu/features/normalizers.py. Its functional forms work
on NumPy arrays or torch tensors (rows normalized independently), so the
same code runs in host assembly and on the device: a tensor stays a
tensor on its own device, anything else becomes a NumPy array (the JAX
package takes jax.numpy for its arrays).
"""
from __future__ import annotations

import numpy as np
import torch


def normalize_l1(x, axis: int = -1):
    if isinstance(x, torch.Tensor):
        s = x.abs().sum(dim=axis, keepdim=True)
        return torch.where(s == 0, torch.zeros_like(x),
                           x / torch.where(s == 0, torch.ones_like(s), s))
    x = np.asarray(x)
    s = np.sum(np.abs(x), axis=axis, keepdims=True)
    return np.where(s == 0, np.zeros_like(x), x / np.where(s == 0, 1, s))


def normalize_l2(x, axis: int = -1):
    if isinstance(x, torch.Tensor):
        s = torch.sqrt((x * x).sum(dim=axis, keepdim=True))
        return torch.where(s == 0, torch.zeros_like(x),
                           x / torch.where(s == 0, torch.ones_like(s), s))
    x = np.asarray(x)
    s = np.sqrt(np.sum(x * x, axis=axis, keepdims=True))
    return np.where(s == 0, np.zeros_like(x), x / np.where(s == 0, 1, s))


class SampleNormalizerL1:
    def fit(self, values):
        return self

    def transform(self, vs) -> np.ndarray:
        return normalize_l1(np.asarray(vs, dtype=np.float64))


class SampleNormalizerL2:
    def fit(self, values):
        return self

    def transform(self, vs) -> np.ndarray:
        return normalize_l2(np.asarray(vs, dtype=np.float64))
