"""Scatter-add of row updates into a table (port of
goctr_tpu/ops/scatter.py:30-37, `scatter_add_rows`).

XLA glue in the JAX package, so a torch op here. The JAX function
scatters in FILL_OR_DROP mode (negative ids and ids past the table are
dropped) and returns a new array; this one drops the same rows and adds
the rest into `table` IN PLACE. Its `sorted_ids` / `unique` promises are
hints to XLA and change no result, so they have no counterpart.

Repeated ids add in the order they come, as XLA's serial scatter adds
them, whatever the number of intra-op threads:
- on the CPU by `index_add_`, which adds each id's rows in the order of
  j at any thread count. The accumulating `index_put_` does not there:
  with more than one thread it adds a repeated id's rows in an order
  that changes from call to call, so a trainer drifts from JAX's over a
  few epochs;
- on the card by the accumulating `index_put_`, which sorts the ids
  stably and takes one pass per id. `index_add_` would add them with
  atomics there, in an order that changes from run to run; the scanned
  trainer's `plain` and `sorted` modes, which add every occurrence of a
  hot id (up to ~7·10^4 a batch at the headline), then differ in their
  f32 rounding.
Used by the trainer's dedup, sorted and plain update modes
(parallel/scanned.py) and the mesh trainer's unpacked update
(parallel/train.py).
"""
from __future__ import annotations

import torch


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """table[ids[j]] += rows[j] for every j with 0 <= ids[j] < V, in
    place and in the order of j for each id; table [V, D], ids [N] int,
    rows [N, D]. Returns the table."""
    keep = (ids >= 0) & (ids < table.shape[0])
    ids, rows = ids[keep].long(), rows[keep]
    if table.device.type == "cpu":
        return table.index_add_(0, ids, rows)
    return table.index_put_((ids,), rows, accumulate=True)
