"""PRNG discipline: one root seed, named streams (port of
goctr_tpu/core/prng.py).

The reference relies on Go's global math/rand plus a numpy-compatible
randomkit RNG (its nn/base/source.go). The JAX package names split keys
so training code never reuses one; here each name gets its own
`torch.Generator`, seeded from the root seed and the name's FNV-1a hash
(the JAX package's `_stable_hash`, copied bit for bit). Torch's streams
are not JAX's: the same seed and name give other numbers in the two
packages, but the same numbers in every run of either.
"""
from __future__ import annotations

import torch

from goctr_tpu_torch.core.dtypes import resolve_device


class PRNGPool:
    """Derives named, counted generators from a root seed.

    >>> pool = PRNGPool(42, device="cpu")
    >>> g1 = pool.next("dropout")   # a fresh stream every call
    >>> g2 = pool.named("init")     # the same stream for a given name
    """

    def __init__(self, seed: int = 0, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._root = int(seed)
        self._counters: dict[str, int] = {}

    def _generator(self, *words: int) -> torch.Generator:
        # the root seed and the words, folded FNV-1a style into 63 bits
        h = (self._root * 0x100000001B3) & 0x7FFFFFFFFFFFFFFF
        for w in words:
            h = ((h ^ w) * 0x100000001B3) & 0x7FFFFFFFFFFFFFFF
        return torch.Generator(device=self.device).manual_seed(h)

    def named(self, name: str) -> torch.Generator:
        """A new generator at the start of `name`'s stream."""
        return self._generator(_stable_hash(name))

    def next(self, name: str) -> torch.Generator:
        """A new generator of `name`'s next counted stream."""
        c = self._counters.get(name, 0)
        self._counters[name] = c + 1
        return self._generator(_stable_hash(name), c)


def _stable_hash(s: str) -> int:
    # FNV-1a 32-bit over the UTF-8 bytes; stable across processes (unlike hash()).
    h = 0x811C9DC5
    for b in s.encode("utf-8"):
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h
