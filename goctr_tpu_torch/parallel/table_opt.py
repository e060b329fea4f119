"""Row-wise embedding-table optimizer config (port of
goctr_tpu/parallel/table_opt.py:14-115).

Same fields, same defaults, same meaning as the JAX TableOptConfig, minus
three that have no counterpart in the port yet:
  * `pallas_interpret` selects a TPU emulation of the Pallas kernels; the
    port's kernels run on the card, their plain versions on the CPU;
  * `gather_impl` chooses between JAX gathers of the packed table; the
    port has one gather, kernel K1;
  * `exchange_cap` belongs to the multi-GPU sharded update (ROADMAP A5).

The scanned trainer of the port accepts `update_mode="fused"` at every
emb_dim < 128 (one row per 128-lane line at emb_dim ≥ 64, grouped lines
below) with either `rmw_impl`; the other update modes raise
NotImplementedError naming the ROADMAP item that brings them
(parallel/scanned.py).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TableOptConfig:
    """Row-wise optimizer for the embedding table.

    kind: "adagrad" (DLRM row-wise adagrad, one accumulator per row,
    packed beside the row's weights) or "sgd".
    update_mode: "fused" — sort the batch's ids, sum duplicate rows, and
    write one updated packed line per unique id (per unique line on
    grouped lines, whose rows are summed per line first).
    sorted_gather: gather the batch's rows in ascending-id order (one
    sort + inverse permutation) instead of raw order.
    compact_cap: > 0 compacts the sorted update stream to at most this
    many unique (id, run-sum) rows before the row update (rounded up to
    ROWS_PER_STEP); uniques beyond it DROP their update and are counted
    (TrainedScanned.update_overflow_max). 0 keeps the position-aligned
    stream (exact for any batch).
    compact_impl: "xla" (rank-sort compaction in plain torch, the JAX
    package's default) or "kernel" (kernel K9, csrc/compact_runsums.cu).
    rmw_impl: "split" — read the lines with kernel K1, compute the
    update in torch, write them back with kernel K4 (csrc/row_scatter.cu);
    "kernel" — one read-modify-write pass per line, kernel K5 on packed
    rows or K6 on grouped lines (csrc/row_rmw.cu).
    """
    kind: str = "adagrad"       # adagrad | sgd
    lr: float = 0.01
    eps: float = 1e-8
    update_mode: str = "fused"
    sorted_gather: bool = False
    compact_cap: int = 0
    compact_impl: str = "xla"   # xla | kernel
    rmw_impl: str = "split"
