"""Hash-based categorical encoders, bit-exact with the reference (port of
goctr_tpu/features/hashing.py).

The reference (go-ctr feature/multihot.go) uses Go's hash/fnv `New32()` —
that is **FNV-1** (multiply-then-xor), not FNV-1a — and buckets with
`int(sum32) % size`. MovieLens feature vectors depend on these exact
bucket assignments (example/movielens/feature.go:87-143), so fnv32 here
must match bit for bit; the tests hold it to the JAX package's.

Dense one-hot rows are the wire format of the small reference models; the
batch API also returns raw bucket indices (`hash_bucket_batch`) for
embedding-table lookups.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

_FNV_OFFSET32 = 0x811C9DC5
_FNV_PRIME32 = 0x01000193
_MASK32 = 0xFFFFFFFF


def fnv32(data: bytes | str) -> int:
    """FNV-1 32-bit (Go hash/fnv New32): h = (h * prime) ^ byte."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    h = _FNV_OFFSET32
    for b in data:
        h = (h * _FNV_PRIME32) & _MASK32
        h ^= b
    return h


def fnv32a(data: bytes | str) -> int:
    """FNV-1a 32-bit (Go hash/fnv New32a): h = (h ^ byte) * prime."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    h = _FNV_OFFSET32
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME32) & _MASK32
    return h


def hash_bucket(value: bytes | str, size: int) -> int:
    """Bucket index of a value: fnv32(value) % size (multihot.go:26-35)."""
    return fnv32(value) % size


def simple_onehot(value: int, size: int) -> np.ndarray:
    """SimpleOneHot multihot.go:9-13."""
    out = np.zeros(size, dtype=np.float32)
    out[value] = 1.0
    return out


def hash_onehot(value: bytes | str, size: int) -> np.ndarray:
    """HashOneHot32 multihot.go:26-35."""
    out = np.zeros(size, dtype=np.float32)
    out[hash_bucket(value, size)] = 1.0
    return out


def string_split_multihot(s: str, sep: str, size: int) -> np.ndarray:
    """StringSplitMultiHot multihot.go:37-49: lowercase each token, set its
    hash bucket (idempotent — repeated tokens stay 1.0)."""
    out = np.zeros(size, dtype=np.float32)
    for tok in s.split(sep):
        out[hash_bucket(tok.lower(), size)] = 1.0
    return out


def hash_bucket_batch(values: Sequence[str] | Iterable[str],
                      size: int) -> np.ndarray:
    """Bucket indices for a batch of strings → int32[n], through the
    native tier (native/hashing.py: the C library, or its Python loop
    where no C compiler is found)."""
    from goctr_tpu_torch.native.hashing import hash_bucket_batch as _native

    return _native(list(values), size)


def multihot_indices(s: str, sep: str, size: int) -> np.ndarray:
    """Bucket indices (deduplicated, order-preserving) of a multi-valued
    field — the sparse counterpart of string_split_multihot."""
    seen: dict[int, None] = {}
    for tok in s.split(sep):
        seen.setdefault(hash_bucket(tok.lower(), size), None)
    return np.fromiter(seen.keys(), dtype=np.int32)
