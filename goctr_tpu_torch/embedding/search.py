"""Nearest-neighbour search over an embedding map (port of
goctr_tpu/embedding/search.py).

The reference loops over every vector per query (brute-force cosine).
Here the vectors are normalised once (numpy, as the JAX package does) and
kept on the device; a batch of queries is one float32 [Q, V] product and
a stable descending sort, so that tied similarities come in index order,
as `jax.lax.top_k` returns them. The product stays in full float32
(resolve_device keeps TF32 off), so the similarities match numpy's.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from goctr_tpu_torch.core.dtypes import resolve_device


class Searcher:

    def __init__(self, emb: Mapping[str, np.ndarray],
                 device: str | torch.device = "cuda"):
        self.words = list(emb.keys())
        if not self.words:
            raise ValueError("empty embedding map")
        self.device = resolve_device(device)
        mat = np.stack([np.asarray(emb[w], dtype=np.float32)
                        for w in self.words])
        norms = np.linalg.norm(mat, axis=1, keepdims=True)
        self._normed = torch.from_numpy(
            mat / np.maximum(norms, 1e-12)).to(self.device)
        self._index = {w: i for i, w in enumerate(self.words)}

    def _topk(self, q: torch.Tensor, k: int):
        qn = q / torch.linalg.vector_norm(
            q, dim=-1, keepdim=True).clamp(min=1e-12)
        sims = qn @ self._normed.T                          # [Q, V]
        sims, idx = torch.sort(sims, dim=-1, descending=True, stable=True)
        return sims[:, :k], idx[:, :k]

    def search_vec(self, query: np.ndarray, k: int = 10
                   ) -> list[list[tuple[str, float]]]:
        q = torch.from_numpy(np.atleast_2d(np.asarray(
            query, np.float32))).to(self.device)
        sims, idx = self._topk(q, min(k, len(self.words)))
        sims, idx = sims.cpu().numpy(), idx.cpu().numpy()
        return [[(self.words[j], float(s)) for j, s in zip(row_i, row_s)]
                for row_i, row_s in zip(idx, sims)]

    def search(self, word: str, k: int = 10) -> list[tuple[str, float]]:
        """Top-k neighbours of a word (itself excluded), the reference
        Searcher.Search semantics."""
        i = self._index.get(word)
        if i is None:
            return []
        res = self.search_vec(self._normed[i].cpu().numpy(), k + 1)[0]
        return [(w, s) for w, s in res if w != word][:k]
