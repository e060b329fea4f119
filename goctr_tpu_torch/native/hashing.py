"""NumPy-facing wrappers over the native host tier, with NumPy/Python
paths where no C compiler is found (port of goctr_tpu/native/hashing.py;
both paths implement FNV-1 32 as Go's hash/fnv does, and give the same
bits as the JAX package's).

Unlike the JAX package's wrappers these check, before any pointer reaches
C: that `out` is a C-contiguous float32 matrix with room for the block at
`col`, that index arrays have one entry a row of `out`, that every gather
index lies within its source's rows (the C gathers read `src[idx]`
unchecked; a negative behavior id, which writes zeros, is the only index
outside them), and that bucket sizes are positive. Both paths raise the
same errors.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from goctr_tpu_torch.native.build import get_lib


def _pack(values: Sequence[str | bytes]) -> tuple[np.ndarray, np.ndarray]:
    bufs = [v.encode("utf-8") if isinstance(v, str) else v for v in values]
    offsets = np.zeros(len(bufs) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in bufs], out=offsets[1:])
    return np.frombuffer(b"".join(bufs), dtype=np.uint8), offsets


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def _check_size(size: int) -> None:
    if int(size) <= 0:
        raise ValueError(f"bucket size must be positive, got {size}")


def _check_out(out: np.ndarray, n: int, col: int, width: int) -> None:
    """out is a C-contiguous float32 [n, ≥ col + width] matrix."""
    if not (isinstance(out, np.ndarray) and out.dtype == np.float32
            and out.ndim == 2 and out.flags.c_contiguous):
        raise ValueError("out must be a C-contiguous float32 matrix, got "
                         f"{getattr(out, 'dtype', type(out))} "
                         f"{getattr(out, 'shape', '')}")
    if out.shape[0] != n:
        raise ValueError(f"{n} index rows for {out.shape[0]} rows of out")
    if col < 0 or col + width > out.shape[1]:
        raise ValueError(f"columns [{col}, {col + width}) outside out's "
                         f"{out.shape[1]}")


def _check_rows(idx: np.ndarray, rows: int, allow_negative: bool = False
                ) -> None:
    """Every index within [0, rows) (negative ones allowed when they
    mean a zero row)."""
    if idx.size == 0:
        return
    lo, hi = int(idx.min()), int(idx.max())
    if hi >= rows or (lo < 0 and not allow_negative):
        raise IndexError(f"gather index outside the source's {rows} rows "
                         f"(min {lo}, max {hi})")


def fnv1_32_batch(values: Sequence[str | bytes]) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        from goctr_tpu_torch.features.hashing import fnv32
        return np.fromiter((fnv32(v) for v in values), dtype=np.uint32,
                           count=len(values))
    buf, off = _pack(values)
    out = np.empty(len(values), dtype=np.uint32)
    lib.fnv1_32_batch(_ptr(buf, ctypes.c_uint8), _ptr(off, ctypes.c_int64),
                      len(values), _ptr(out, ctypes.c_uint32))
    return out


def fnv1a_32_batch(values: Sequence[str | bytes]) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        from goctr_tpu_torch.features.hashing import fnv32a
        return np.fromiter((fnv32a(v) for v in values), dtype=np.uint32,
                           count=len(values))
    buf, off = _pack(values)
    out = np.empty(len(values), dtype=np.uint32)
    lib.fnv1a_32_batch(_ptr(buf, ctypes.c_uint8), _ptr(off, ctypes.c_int64),
                       len(values), _ptr(out, ctypes.c_uint32))
    return out


def hash_bucket_batch(values: Sequence[str | bytes], size: int) -> np.ndarray:
    _check_size(size)
    lib = get_lib()
    if lib is None:
        from goctr_tpu_torch.features.hashing import fnv32
        return np.fromiter((fnv32(v) % size for v in values), dtype=np.int32,
                           count=len(values))
    buf, off = _pack(values)
    out = np.empty(len(values), dtype=np.int32)
    lib.hash_bucket_batch(_ptr(buf, ctypes.c_uint8),
                          _ptr(off, ctypes.c_int64), len(values),
                          size, _ptr(out, ctypes.c_int32))
    return out


def multihot_batch(values: Sequence[str], sep: str, size: int) -> np.ndarray:
    """[n, size] dense multi-hot (StringSplitMultiHot semantics: lowercase
    tokens, FNV-1 buckets); `sep` is one ASCII character."""
    _check_size(size)
    if len(sep) != 1 or ord(sep) > 127:
        raise ValueError(f"sep must be one ASCII character, got {sep!r}")
    lib = get_lib()
    if lib is None:
        from goctr_tpu_torch.features.hashing import string_split_multihot
        return np.stack([string_split_multihot(v, sep, size)
                         for v in values]) if values else \
            np.zeros((0, size), np.float32)
    buf, off = _pack(values)
    out = np.zeros((len(values), size), dtype=np.float32)
    lib.multihot_batch(_ptr(buf, ctypes.c_uint8), _ptr(off, ctypes.c_int64),
                       len(values), ord(sep), size,
                       _ptr(out, ctypes.c_float))
    return out


def gather_rows_into(out: np.ndarray, col: int, src: np.ndarray,
                     idx: np.ndarray) -> None:
    """out[:, col:col+w] = src[idx] without materializing src[idx] (the
    C pass writes straight into the strided destination, 2 threads from
    2^19 rows)."""
    src = np.ascontiguousarray(src, dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    n, w = idx.shape[0], src.shape[1]
    _check_out(out, n, col, w)
    _check_rows(idx, src.shape[0])
    lib = get_lib()
    if lib is None:
        out[:, col:col + w] = src[idx]
        return
    lib.gather_rows(_ptr(src, ctypes.c_float), _ptr(idx, ctypes.c_int64),
                    n, w, _ptr(out, ctypes.c_float), out.shape[1], col)


def gather_emb_rows_into(out: np.ndarray, col: int, emb: np.ndarray,
                         idx2d: np.ndarray) -> None:
    """out[r, col+l*d : col+(l+1)*d] = emb[idx2d[r, l]] (negative idx →
    zeros) — the behavior-embedding block written directly into the sample
    matrix, with no [n, L·d] intermediate."""
    emb = np.ascontiguousarray(emb, dtype=np.float32)
    idx2d = np.ascontiguousarray(idx2d, dtype=np.int64)
    n, L = idx2d.shape
    d = emb.shape[1]
    _check_out(out, n, col, L * d)
    _check_rows(idx2d, emb.shape[0], allow_negative=True)
    lib = get_lib()
    if lib is None:
        safe = idx2d.clip(0)
        block = emb[safe]
        block[idx2d < 0] = 0.0
        out[:, col:col + L * d] = block.reshape(n, L * d)
        return
    lib.gather_emb_rows(_ptr(emb, ctypes.c_float),
                        _ptr(idx2d, ctypes.c_int64), n, L, d,
                        _ptr(out, ctypes.c_float), out.shape[1], col)


def gather_rows_concat(blocks: Sequence[tuple[np.ndarray, np.ndarray]]
                       ) -> np.ndarray:
    """X[r] = concat(block_src[idx[r]] for each (src, idx) block): the
    batched sample-assembly primitive (in place of the reference's
    per-sample goroutine loop, rcmd.go:375-397)."""
    if not blocks:
        return np.zeros((0, 0), np.float32)
    n = len(blocks[0][1])
    width = sum(src.shape[1] for src, _ in blocks)
    out = np.empty((n, width), dtype=np.float32)
    col = 0
    for src, idx in blocks:
        gather_rows_into(out, col, src, idx)
        col += src.shape[1]
    return out
