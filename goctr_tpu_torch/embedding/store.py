"""Embedding artifacts: the word→vector map, text model file io, and the
high-level train_embedding entry (port of goctr_tpu/embedding/store.py).

Text format parity with the reference (`word v1 v2 ... vn` per line, each
value written as `repr(float(x))`): for the same vectors the file is byte
for byte what the JAX package writes. train_embedding mirrors the
reference's TrainEmbedding defaults (SkipGram + hierarchical softmax,
the caller's window/dim/iters) and trains on `device`.
"""
from __future__ import annotations

import io
from pathlib import Path
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from goctr_tpu_torch.embedding.word2vec import Word2Vec, Word2VecOptions


class EmbeddingMap(dict):
    """word → np.ndarray[D]; the artifact consumed by the recommender
    (the reference's EmbeddingMap32)."""

    @property
    def dim(self) -> int:
        for v in self.values():
            return int(np.asarray(v).shape[0])
        return 0

    def get_vec(self, word: str, dim: Optional[int] = None) -> np.ndarray:
        v = self.get(word)
        if v is not None:
            return np.asarray(v, dtype=np.float32)
        return np.zeros(dim or self.dim, dtype=np.float32)

    def as_arrays(self) -> tuple[list[str], np.ndarray]:
        words = list(self.keys())
        mat = np.stack([np.asarray(self[w], dtype=np.float32)
                        for w in words]) if words else np.zeros((0, 0))
        return words, mat


def embedding_map_from_model(model: Word2Vec, agg: bool = True,
                             min_count_only: bool = True) -> EmbeddingMap:
    """The reference's GenEmbeddingMap32: each word kept by min_count."""
    vecs = model.vectors(agg)
    d = model.dictionary
    counts = d.counts_array()
    out = EmbeddingMap()
    for i, w in enumerate(d.id2word):
        if min_count_only and counts[i] < model.opts.min_count:
            continue
        out[w] = vecs[i]
    return out


def train_embedding(item_seqs: Iterable[Sequence[str] | str],
                    window: int = 5, dim: int = 16, iters: int = 1,
                    device: str | torch.device = "cuda",
                    **kw) -> EmbeddingMap:
    """High-level entry mirroring the reference's TrainEmbedding (SkipGram
    + HS); returns the word→vec map directly."""
    opts = Word2VecOptions(dim=dim, window=window, iters=iters,
                           model="skipgram", optimizer="hs", **kw)
    model = Word2Vec(opts, device=device).train(item_seqs)
    return embedding_map_from_model(model)


# ------------------------------------------------------------------ file io --

def save_embedding_map(f: io.TextIOBase | str | Path,
                       emb: Mapping[str, np.ndarray]) -> None:
    """`word v1 v2 ... vn` per line (reference vector.Save format)."""
    close = False
    if isinstance(f, (str, Path)):
        f = open(f, "w")
        close = True
    try:
        for w, v in emb.items():
            vec = " ".join(repr(float(x)) for x in np.asarray(v).ravel())
            f.write(f"{w} {vec}\n")
    finally:
        if close:
            f.close()


def load_embedding_map(f: io.TextIOBase | str | Path) -> EmbeddingMap:
    """Parse the text model format (the reference's emb.Load)."""
    close = False
    if isinstance(f, (str, Path)):
        f = open(f)
        close = True
    out = EmbeddingMap()
    try:
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < 2:
                continue
            out[parts[0]] = np.asarray([float(x) for x in parts[1:] if x],
                                       dtype=np.float32)
    finally:
        if close:
            f.close()
    return out
