"""Row-wise embedding-table optimizer config (port of
goctr_tpu/parallel/table_opt.py:14-115).

Same fields, same defaults, same meaning as the JAX TableOptConfig, minus
two that have no counterpart in the port (a checkpoint's `table_opt`
that holds them loads without them, models/io.py):
  * `pallas_interpret` selects a TPU emulation of the Pallas kernels; the
    port's kernels run on the card, their plain versions on the CPU;
  * `gather_impl` chooses between JAX gathers of the packed table; the
    port has one gather, kernel K1.

The port's scanned trainer accepts every update_mode of the JAX
trainer; each picks the table's layout and the kernel of its update
(parallel/scanned.py's module docstring has the table):
  * fused    — packed [V, 128] rows at emb_dim >= 64, grouped lines below;
               split update (K1, K4) or one pass (K5 rows, K6 lines),
               compaction by rank-sort glue or K9;
  * fused2   — packed [V, 128] rows at every emb_dim < 128; K7;
  * runfused — packed [V, 128] rows at every emb_dim < 128; K8;
  * dedup    — [V + junk, D] table and [V + junk] accumulator; torch;
  * sorted, plain — [V, D] table and [V] accumulator; torch, adagrad per
               occurrence.
The three packed modes require emb_dim < 128. The mesh trainer
(parallel/train.py) routes the modes its own way: fused2 and runfused
take the fused row update there (K5 or split), dedup, sorted and plain
one scatter pair.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TableOptConfig:
    """Row-wise optimizer for the embedding table.

    kind: "adagrad" (DLRM row-wise adagrad, one accumulator per row,
    packed beside the row's weights in the packed modes) or "sgd".
    update_mode: "fused" — sort the batch's ids, sum duplicate rows, and
    write one updated packed line per unique id (per unique line on
    grouped lines, whose rows are summed per line first); "fused2" — sort,
    one cumsum, and kernel K7 recovers each run's sum as a difference of
    cumsum rows; "runfused" — sort, and kernel K8 sums each run; "dedup"
    — sort, sum duplicates, one add per unique id into [V + junk, D];
    "sorted" / "plain" — add every occurrence (sorted, or in batch
    order), each scaled by the accumulator after all of the batch's adds.
    compact_cap, compact_impl and rmw_impl apply to "fused" only.
    sorted_gather: gather the batch's rows in ascending-id order (one
    sort + inverse permutation) instead of raw order.
    compact_cap: > 0 compacts the sorted update stream to at most this
    many unique (id, run-sum) rows before the row update (rounded up to
    ROWS_PER_STEP); uniques beyond it DROP their update and are counted
    (TrainedScanned.update_overflow_max). 0 keeps the position-aligned
    stream (exact for any batch).
    exchange_cap: the mesh trainer's sparse step (parallel/train.py)
    compacts each batch's row gradients to at most this many unique (id,
    run-sum) rows (rounded up to ROWS_PER_STEP; 0 = all of them, exact for
    any batch); uniques beyond it DROP their update and are counted
    (TrainedSparseRanker.lookup_overflow_max).
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
    exchange_cap: int = 0
    compact_impl: str = "xla"   # xla | kernel
    rmw_impl: str = "split"
