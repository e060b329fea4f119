"""Bag-of-words and TF-IDF vectorizers; parity with
the reference's feature/textprocesors.go.

The port's own copy of goctr_tpu/features/text.py (numpy only).

CountVectorizer: vocabulary by first occurrence across separator-split
tokens, empty tokens skipped; transform counts occurrences (whole-string
match when the separator is absent). TFIDFVectorizer: non-smooth idf
tf*(log(N/df)+1) followed by L2 sample normalization (textprocesors.go:128-197).
"""
from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np

from goctr_tpu_torch.features.normalizers import normalize_l2


class CountVectorizer:

    def __init__(self, separator: str = " "):
        self.separator = separator or " "
        self.mapping: dict[str, int] = {}

    def fit(self, docs: Iterable[str]) -> "CountVectorizer":
        self.mapping = {}
        for doc in docs:
            for w in doc.split(self.separator):
                if w == "":
                    continue
                if w not in self.mapping:
                    self.mapping[w] = len(self.mapping)
        return self

    @property
    def num_features(self) -> int:
        return len(self.mapping)

    def feature_names(self) -> list[str]:
        names = [""] * self.num_features
        for w, i in self.mapping.items():
            names[i] = w
        return names

    def transform(self, doc: str) -> np.ndarray:
        out = np.zeros(self.num_features, dtype=np.float64)
        if not doc or not self.mapping:
            return out
        if self.separator not in doc:
            # whole-string match (textprocesors.go:96-101)
            idx = self.mapping.get(doc)
            if idx is not None:
                out[idx] = 1.0
            return out
        for w in doc.split(self.separator):
            idx = self.mapping.get(w)
            if idx is not None:
                out[idx] += 1.0
        return out

    def transform_batch(self, docs: Sequence[str]) -> np.ndarray:
        return np.stack([self.transform(d) for d in docs]) if docs else \
            np.zeros((0, self.num_features))


class TFIDFVectorizer(CountVectorizer):

    def __init__(self, separator: str = " "):
        super().__init__(separator)
        self.doc_count: np.ndarray = np.zeros(0)
        self.num_documents: int = 0

    def fit(self, docs: Sequence[str]) -> "TFIDFVectorizer":
        super().fit(docs)
        self.num_documents = len(docs)
        self.doc_count = np.zeros(self.num_features, dtype=np.int64)
        for doc in docs:
            counts = super().transform(doc)
            self.doc_count += counts > 0
        return self

    def transform(self, doc: str) -> np.ndarray:
        tf = super().transform(doc)
        out = np.zeros_like(tf)
        nz = (tf > 0) & (self.doc_count > 0)
        out[nz] = tf[nz] * (np.log(self.num_documents / self.doc_count[nz]) + 1)
        return normalize_l2(out)
