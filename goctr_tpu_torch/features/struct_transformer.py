"""Record → feature-vector transformer.

The port's own copy of goctr_tpu/features/struct_transformer.py (numpy only).

The reference's StructTransformer (the reference's feature/transformer.go)
walks Go struct fields with reflection; the Python-native equivalent walks a
field spec over dicts / dataclasses / sequences, applying one fitted
transformer per field and concatenating outputs. Expanding transformers
(one-hot, count/tfidf) contribute num_features columns; scalar ones
contribute 1; a None transformer skips the field.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np


class StructTransformer:

    def __init__(self, transformers: Sequence[Optional[object]],
                 fields: Optional[Sequence[str]] = None):
        self.transformers = list(transformers)
        self.fields = list(fields) if fields is not None else None

    # ---------------------------------------------------------------- fit --
    def fit(self, records: Sequence[Any]) -> "StructTransformer":
        cols = [self._field_values(records, i)
                for i in range(len(self.transformers))]
        for t, col in zip(self.transformers, cols):
            if t is not None:
                t.fit(col)
        return self

    # ---------------------------------------------------------- transform --
    def transform(self, record: Any) -> np.ndarray:
        parts: list[np.ndarray] = []
        for i, t in enumerate(self.transformers):
            if t is None:
                continue
            v = self._get(record, i)
            out = t.transform(v)
            parts.append(np.atleast_1d(np.asarray(out, dtype=np.float64)))
        return np.concatenate(parts) if parts else np.zeros(0)

    def transform_batch(self, records: Sequence[Any]) -> np.ndarray:
        return np.stack([self.transform(r) for r in records])

    @property
    def num_features(self) -> int:
        n = 0
        for t in self.transformers:
            if t is None:
                continue
            n += getattr(t, "num_features", 1) if hasattr(t, "num_features") else 1
        return n

    # ------------------------------------------------------------ helpers --
    def _get(self, record: Any, i: int) -> Any:
        if self.fields is not None:
            name = self.fields[i]
            if isinstance(record, dict):
                return record[name]
            return getattr(record, name)
        if dataclasses.is_dataclass(record):
            return getattr(record, dataclasses.fields(record)[i].name)
        return record[i]

    def _field_values(self, records: Sequence[Any], i: int) -> list[Any]:
        return [self._get(r, i) for r in records]
