"""Label transformers; parity with the reference's feature/preprocessing/
label.go (LabelBinarizer :13-105, MultiLabelBinarizer :108-270,
LabelEncoder :273-340).

The port's own copy of goctr_tpu/features/preprocessing/label.py (numpy only).
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


class LabelEncoder:
    """Sorted-unique classes → 0..K-1 (label.go:273-340)."""

    def fit(self, y):
        self.classes_ = np.unique(np.asarray(y).ravel())
        return self

    def transform(self, y):
        y = np.asarray(y).ravel()
        idx = np.searchsorted(self.classes_, y)
        idx = np.clip(idx, 0, self.classes_.size - 1)
        if not np.all(self.classes_[idx] == y):
            raise ValueError("y contains unseen labels")
        return idx

    def fit_transform(self, y):
        return self.fit(y).transform(y)

    def inverse_transform(self, idx):
        return self.classes_[np.asarray(idx, dtype=np.int64).ravel()]


class LabelBinarizer:
    """One-vs-all 0/1 indicator matrix (label.go:13-105); binary targets
    produce a single column like sklearn."""

    def __init__(self, neg_label: float = 0.0, pos_label: float = 1.0):
        self.neg_label = neg_label
        self.pos_label = pos_label

    def fit(self, y):
        self.classes_ = np.unique(np.asarray(y).ravel())
        return self

    def transform(self, y):
        y = np.asarray(y).ravel()
        k = self.classes_.size
        if k == 2:
            out = np.full((y.size, 1), self.neg_label)
            out[y == self.classes_[1], 0] = self.pos_label
            return out
        out = np.full((y.size, k), self.neg_label)
        for i, c in enumerate(self.classes_):
            out[y == c, i] = self.pos_label
        return out

    def fit_transform(self, y):
        return self.fit(y).transform(y)

    def inverse_transform(self, Y):
        Y = np.asarray(Y)
        if self.classes_.size == 2:
            mid = (self.pos_label + self.neg_label) / 2
            return np.where(Y[:, 0] > mid, self.classes_[1],
                            self.classes_[0])
        return self.classes_[np.argmax(Y, axis=1)]


class MultiLabelBinarizer:
    """Sets of labels → multi-hot rows (label.go:108-270)."""

    def fit(self, y: Iterable[Sequence]):
        all_labels = sorted({l for row in y for l in row})
        self.classes_ = np.asarray(all_labels)
        self._index = {l: i for i, l in enumerate(all_labels)}
        return self

    def transform(self, y: Iterable[Sequence]) -> np.ndarray:
        rows = list(y)
        out = np.zeros((len(rows), self.classes_.size))
        for r, labels in enumerate(rows):
            for l in labels:
                i = self._index.get(l)
                if i is not None:
                    out[r, i] = 1.0
        return out

    def fit_transform(self, y):
        y = list(y)
        return self.fit(y).transform(y)

    def inverse_transform(self, Y) -> list[tuple]:
        Y = np.asarray(Y)
        return [tuple(self.classes_[np.nonzero(row)[0]]) for row in Y]
