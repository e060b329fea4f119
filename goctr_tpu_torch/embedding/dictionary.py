"""Corpus dictionary: word ↔ id by first occurrence, with counts (port of
goctr_tpu/embedding/dictionary.py, numpy only, kept as its own copy).

Parity with the reference's corpus dictionary (insertion-order ids,
cumulative counts), plus vectorized doc encoding and the word2vec
subsampling table, which the reference computes per word visit and this
module precomputes per vocabulary entry. Tokens may be `str` or `int`.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Optional, Sequence

import numpy as np


class Dictionary:

    def __init__(self):
        self.word2id: dict[str, int] = {}
        self.id2word: list[str] = []
        self.counts: list[int] = []

    def __len__(self) -> int:
        return len(self.id2word)

    def add(self, *words: str) -> None:
        for w in words:
            i = self.word2id.get(w)
            if i is None:
                self.word2id[w] = len(self.id2word)
                self.id2word.append(w)
                self.counts.append(1)
            else:
                self.counts[i] += 1

    def id_of(self, word: str) -> Optional[int]:
        return self.word2id.get(word)

    def word(self, i: int) -> str:
        return self.id2word[i]

    def freq(self, word: str) -> int:
        i = self.word2id.get(word)
        return 0 if i is None else self.counts[i]

    def counts_array(self) -> np.ndarray:
        return np.asarray(self.counts, dtype=np.int64)

    # -------------------------------------------------------------- corpus --
    @classmethod
    def build(cls, docs: Iterable[Sequence[str] | str],
              to_lower: bool = False) -> tuple["Dictionary", list[np.ndarray]]:
        """One pass: dictionary + encoded docs (int32 id arrays)."""
        d = cls()
        encoded: list[np.ndarray] = []
        for doc in docs:
            toks = doc.split() if isinstance(doc, str) else doc
            if to_lower:
                toks = [t.lower() for t in toks]
            ids = np.empty(len(toks), dtype=np.int32)
            w2i, i2w, cnt = d.word2id, d.id2word, d.counts
            for j, w in enumerate(toks):
                i = w2i.get(w)
                if i is None:
                    i = len(i2w)
                    w2i[w] = i
                    i2w.append(w)
                    cnt.append(1)
                else:
                    cnt[i] += 1
                ids[j] = i
            encoded.append(ids)
        return d, encoded

    def encode(self, doc: Sequence[str] | str,
               to_lower: bool = False) -> np.ndarray:
        """Tokens → int32 ids without mutating counts (streaming pass 2;
        unknown words are dropped, matching the fs-corpus re-read where the
        dictionary is already frozen)."""
        toks = doc.split() if isinstance(doc, str) else doc
        if to_lower:
            toks = [t.lower() for t in toks]
        w2i = self.word2id
        ids = [w2i[t] for t in toks if t in w2i]
        return np.asarray(ids, dtype=np.int32)

    def keep_probs(self, threshold: float = 1e-3) -> np.ndarray:
        """Per-id subsampling keep probability (wego modelutil/subsample:
        p = (sqrt(fr/t) + 1) * t/fr, clipped to 1), fr = freq/total."""
        counts = self.counts_array().astype(np.float64)
        total = counts.sum()
        if total == 0 or threshold <= 0:
            return np.ones_like(counts)
        fr = counts / total
        with np.errstate(divide="ignore", invalid="ignore"):
            p = (np.sqrt(fr / threshold) + 1.0) * (threshold / fr)
        return np.clip(np.nan_to_num(p, nan=1.0, posinf=1.0), 0.0, 1.0)

    def unigram_table(self, size: int = 1 << 20,
                      power: float = 0.75) -> np.ndarray:
        """Negative-sampling table: id sampled ∝ count^power (word2vec
        standard; reference optimizer.go negativeSampling uses the same)."""
        counts = self.counts_array().astype(np.float64)
        probs = counts ** power
        probs /= probs.sum()
        bounds = np.cumsum(probs) * size
        table = np.zeros(size, dtype=np.int32)
        prev = 0
        for i, b in enumerate(np.round(bounds).astype(np.int64)):
            table[prev:b] = i
            prev = b
        table[prev:] = len(counts) - 1
        return table
