"""Scatter-add of row updates into a table (port of
goctr_tpu/ops/scatter.py:30-37, `scatter_add_rows`).

XLA glue in the JAX package, so a torch op here. The JAX function
scatters in FILL_OR_DROP mode (negative ids and ids past the table are
dropped) and returns a new array; this one drops the same rows and adds
the rest into `table` IN PLACE. Its `sorted_ids` / `unique` promises are
hints to XLA and change no result, so they have no counterpart.

Rows are dropped without a shape that depends on the data, so the host
never waits on the card: a boolean mask (`ids[keep]`) would run a
`nonzero` and wait for its size. Each dropped row becomes -0.0, the
exact identity of IEEE addition (x + (-0.0) is x bit for bit, ±0 and
NaN included; +0.0 is not: it turns a stored -0.0 into +0.0), and goes
to an id that kept rows go to as well, spread over the kept rows that
begin a run of equal ids (over the distinct ids of a sorted stream: no
hot id's run grows much, and not all go to one id, whose occurrences the
card's scatter walks one by one). An id no kept row goes to is never
touched, as with the mask: the card's scatter sums an id's rows from
+0.0 before it adds them to the table, which would turn a stored -0.0
into +0.0. The kept rows' sums are the same sequence of adds as with the
mask, except on the card at one column, below.

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
  f32 rounding. At more than one column `index_put_` adds an id's rows
  one after another, so the -0.0 rows change nothing. At one column (the
  adagrad accumulator) it sums an id's rows in 32 lanes first, so a row
  more or fewer in a group moves the others to other lanes and changes
  the rounding: there the dropped rows go to JUNK_ROWS scratch rows past
  a copy of the table's column, which is then copied back (two passes
  over the column, 160 MB at V = 10M). When no row is kept, the dropped
  rows go to j mod V.
Used by the trainer's dedup, sorted and plain update modes
(parallel/scanned.py) and the mesh trainer's unpacked update
(parallel/train.py).
"""
from __future__ import annotations

import torch

# scratch rows that take the dropped rows of a one-column scatter on the
# card (a few dozen dropped rows each at the mesh's stage-4 streams)
JUNK_ROWS = 1 << 16


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """table[ids[j]] += rows[j] for every j with 0 <= ids[j] < V, in
    place and in the order of j for each id; table [V, D], ids [N] int,
    rows [N, D]. Returns the table."""
    v, n = table.shape[0], ids.shape[0]
    if not v or not n:
        return table
    ids = ids.long()
    keep = (ids >= 0) & (ids < v)
    rows = torch.where(keep[:, None], rows, -0.0)
    j = torch.arange(n, device=ids.device)
    if table.device.type != "cpu" and table.shape[1] == 1:
        wide = torch.cat([table, table.new_zeros((JUNK_ROWS, 1))])
        wide.index_put_((torch.where(keep, ids, v + j % JUNK_ROWS),), rows,
                        accumulate=True)
        return table.copy_(wide[:v])
    # the kept rows that begin a run of equal ids, in stream order
    first = keep.clone()
    first[1:] &= ids[1:] != ids[:-1]
    rank = torch.cumsum(first, 0) - 1
    firsts = ids.new_zeros(n + 1)
    firsts[torch.where(first, rank, n)] = ids
    n_first = rank[-1:] + 1
    spread = torch.where(n_first > 0, firsts[j % n_first.clamp_min(1)],
                         j % v)
    tgt = torch.where(keep, ids, spread)
    if table.device.type == "cpu":
        return table.index_add_(0, tgt, rows)
    return table.index_put_((tgt,), rows, accumulate=True)
