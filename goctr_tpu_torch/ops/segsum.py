"""Sorted-segment row sums — the dedup front end of the fused table
update (port of goctr_tpu/ops/segsum.py).

XLA glue in the JAX package, so plain torch here: a two-level blockwise
cumsum over the sorted rows, a cummax for each position's run start, and
one row gather at the run boundaries,

    run_sum(end i) = cumsum[i] − cumsum_exclusive[run_start(i)].

The output stays position-aligned: position i carries its full run sum
iff it is the last position of its run, else zeros, and its target id is
a distinct junk id past the vocab. Sorts are stable (`torch.sort(...,
stable=True)`, as `jnp.argsort` is), so equal ids keep their order and
their rows are summed in the JAX package's order.
"""
from __future__ import annotations

import torch

_BLOCK = 1024


def _cumsum_rows(x: torch.Tensor, block: int = _BLOCK) -> torch.Tensor:
    """Inclusive cumsum along dim 0 of [n, D], two-level blockwise (the
    in-block scan batched over blocks, then the block offsets). Requires
    n % block == 0."""
    n, d = x.shape
    if n % block:
        raise ValueError(f"n={n} must be a multiple of block={block}")
    cb = x.reshape(n // block, block, d).cumsum(1)
    tot = cb[:, -1]                                  # [nb, D]
    off = tot.cumsum(0) - tot                        # exclusive offsets
    return (cb + off[:, None, :]).reshape(n, d)


def _cummax_i32(x: torch.Tensor, block: int = _BLOCK) -> torch.Tensor:
    """Inclusive cummax along a [n] int32 vector, same two-level scheme."""
    n = x.shape[0]
    if n % block:
        raise ValueError(f"n={n} must be a multiple of block={block}")
    cb = x.reshape(n // block, block).cummax(1).values
    tot = cb[:, -1]
    off = torch.cat([torch.full((1,), torch.iinfo(torch.int32).min,
                                dtype=x.dtype, device=x.device),
                     tot.cummax(0).values[:-1]])
    return torch.maximum(cb, off[:, None]).reshape(n)


def sorted_run_sums(s_ids: torch.Tensor, s_rows: torch.Tensor,
                    junk_base: int):
    """(tgt [n] int32, rows [n, D]) for SORTED ids: position i is the last
    of its run → tgt = s_ids[i], rows = the full run sum; otherwise tgt =
    junk_base + i (pairwise distinct), rows = 0. n % 1024 == 0."""
    n = s_rows.shape[0]
    dev = s_ids.device
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    c = _cumsum_rows(s_rows)
    differs = s_ids[1:] != s_ids[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    is_start = torch.cat([one, differs])
    is_end = torch.cat([differs, one])
    start = _cummax_i32(torch.where(is_start, pos, 0))
    c_ex = c - s_rows                                # exclusive cumsum
    c_before = c_ex.index_select(0, start.long())    # sum before my run
    rows = torch.where(is_end[:, None], c - c_before, 0.0)
    tgt = torch.where(is_end, s_ids, junk_base + pos).to(torch.int32)
    return tgt, rows


def segment_rows_dedup(ids: torch.Tensor, rows: torch.Tensor, vocab: int,
                       pad_to: int = 0):
    """Dedup front end: raw ids [n] (-1 = pad, duplicates) + row grads
    [n, D] → (tgt [n], summed rows [n, D]), tgt pairwise distinct, every
    non-real target in [vocab, vocab + 1 + n). Negative ids contribute
    nothing; pads share the id `vocab` (one zero-sum run). With pad_to >
    n the inputs are first padded with -1 ids and zero rows."""
    n = ids.shape[0]
    if pad_to > n:
        ids = torch.cat([ids, torch.full((pad_to - n,), -1, dtype=ids.dtype,
                                         device=ids.device)])
        rows = torch.cat([rows, rows.new_zeros((pad_to - n, rows.shape[1]))])
    valid = ids >= 0
    rows = rows * valid[:, None].to(rows.dtype)
    ids_clean = torch.where(valid, ids, vocab)
    order = torch.sort(ids_clean, stable=True).indices
    return sorted_run_sums(ids_clean[order], rows[order], junk_base=vocab + 1)
