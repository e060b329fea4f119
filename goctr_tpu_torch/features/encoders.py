"""Vocabulary-based categorical encoders.

The port's own copy of goctr_tpu/features/encoders.py (numpy only).

Parity with the reference's feature/categorical.go (OneHotEncoder 10-68,
OrdinalEncoder 71-104): first-occurrence-order vocabularies, empty strings
ignored, unseen values → all-zeros (one-hot) / 0 (ordinal).
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np


class OneHotEncoder:
    """Fit assigns indices by order of first occurrence; unseen → zeros."""

    def __init__(self, mapping: Optional[dict[str, int]] = None):
        self.mapping: dict[str, int] = mapping or {}

    def fit(self, values: Iterable[str]) -> "OneHotEncoder":
        self.mapping = {}
        for v in values:
            if v == "":
                continue
            if v not in self.mapping:
                self.mapping[v] = len(self.mapping)
        return self

    @property
    def num_features(self) -> int:
        return len(self.mapping)

    def feature_names(self) -> list[str]:
        names = [""] * self.num_features
        for w, i in self.mapping.items():
            names[i] = w
        return names

    def transform(self, value: str) -> np.ndarray:
        out = np.zeros(self.num_features, dtype=np.float32)
        idx = self.mapping.get(value)
        if idx is not None:
            out[idx] = 1.0
        return out

    def transform_index(self, value: str) -> int:
        """Index form for embedding-table lookup; -1 for unseen."""
        return self.mapping.get(value, -1)

    def transform_batch(self, values: Sequence[str]) -> np.ndarray:
        """Dense [n, num_features] one-hot block."""
        out = np.zeros((len(values), self.num_features), dtype=np.float32)
        for r, v in enumerate(values):
            idx = self.mapping.get(v)
            if idx is not None:
                out[r, idx] = 1.0
        return out

    def transform_indices(self, values: Sequence[str]) -> np.ndarray:
        return np.fromiter((self.mapping.get(v, -1) for v in values),
                           dtype=np.int32, count=len(values))


class OrdinalEncoder:
    """Fit assigns 1..N by first occurrence; unseen → 0 (categorical.go:71-104)."""

    def __init__(self, mapping: Optional[dict[str, int]] = None):
        self.mapping: dict[str, int] = mapping or {}

    def fit(self, values: Iterable[str]) -> "OrdinalEncoder":
        self.mapping = {}
        for v in values:
            if v == "":
                continue
            if v not in self.mapping:
                self.mapping[v] = len(self.mapping) + 1
        return self

    def transform(self, value: str) -> float:
        return float(self.mapping.get(value, 0))

    def transform_batch(self, values: Sequence[str]) -> np.ndarray:
        return np.fromiter((self.mapping.get(v, 0) for v in values),
                           dtype=np.float32, count=len(values))
