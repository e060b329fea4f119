"""Device-resident scanned trainer for SparseCTR, its result and its
checkpoints (port of goctr_tpu/parallel/scanned.py: TrainedScanned
:58-123, GROUPED_RESIDENT_MIN_V :128, table_pad_rows :135-144,
_table_update :147-380, train_sparse_scanned :383-671, checkpoints
:674-755, the analytic per-example counts :758-827).

The whole dataset lives on the device. Each step gathers the batch's rows
with kernel K1, differentiates the loss with respect to the gathered rows
(the table never enters autograd: no [V, D] gradient), takes one solver
step on the dense parameters, and updates the table in place with
row-wise adagrad (one accumulator a row) or sgd. `update_mode` picks the
table's layout and its update, as in the JAX trainer:

  mode      layout (emb_dim D)                  update of one batch
  fused     packed [V, 128] rows (w | acc | 0)  sort the ids, sum each id's
            at D >= 64; grouped lines below:    rows (ops/segsum.py, or
            G = 128 // (D+1) rows a line,       with compact_cap > 0 the
            [ceil(V/G), 128]                    compaction: rank-sort glue
                                                or K9); on grouped lines
                                                sum the rows of a line
                                                (`line_stream`); then split
                                                (K1 read, torch, K4) or one
                                                pass (K5 rows, K6 lines)
  fused2    packed [V, 128] rows at every       sort, one blockwise cumsum,
            D < 128                             kernel K7 (run sums as
                                                cumsum differences)
  runfused  packed [V, 128] rows at every       sort, kernel K8 (runs
            D < 128                             summed in the kernel)
  dedup     [V + table_pad_rows, D] and acc     sort and sum each id's rows
            [V + table_pad_rows]                (ops/segsum.py), add the
                                                unique rows into the table
                                                and acc (junk targets past
                                                V; ops/scatter.py)
  sorted    [V, D] and acc [V]                  stable sort, add every
                                                occurrence (ops/scatter.py):
                                                adagrad per occurrence
  plain     [V, D] and acc [V]                  add every occurrence in
                                                batch order

The three packed modes require D < 128 (weights and accumulator share a
128-lane line); the other three take any D. fused, fused2, runfused and
dedup apply the same row-wise adagrad to each id's summed gradient;
sorted and plain add each occurrence's ‖g‖² to the accumulator and scale
every occurrence by the accumulator after all of them (the JAX trainer's
Hogwild-style per-occurrence update), different arithmetic.

Loss and overflow stay on the device; the host syncs once per epoch, as
the JAX trainer does (`float(cost)` once per epoch, :633-634). Padded
update slots follow the JAX trainer: the stream is padded to a multiple
of ROWS_PER_STEP with pad id V, and junk targets are V+1+k (on lines
L+n+1+k), which the packed row updates skip and dedup's table holds.

Random streams: shuffling and dropout draw from one torch.Generator
seeded from `TrainerConfig.seed` (and, on resume, the epochs done). They
cannot match JAX's threefry streams; parity tests run with shuffle=False
and dropout 0.

A checkpoint is a directory of `meta.json` (model config, loss curve,
trainer config), `dense.npz` (flattened dense parameters, models/io.py
names), `table.npz` (`table` [V, D] f32 and the adagrad `acc` [V], empty
when absent) and `opt_state.npz` (the solver state's leaves "0", "1", ...
in JAX leaf order), written the same way by both packages, so either
loads the other's. Grouped line tables are unpacked to [V, D] on save,
and dedup's junk rows trimmed, as the JAX package does.

Results: at a vocab of GROUPED_RESIDENT_MIN_V or more a grouped `fused`
run draws its fresh table straight into line layout and returns the
lines ([L, 128], `packed_group` = G, no acc: it lives in the lines), as
the JAX trainer does (a [100M, 16] table is not drawn, and the lines are
7.3 GB). Every other run returns a contiguous [V, D] table and its [V]
acc; dedup's carry its junk rows ([V + table_pad_rows, D]), as JAX's do.
A run resumes from any of these layouts in any mode: grouped lines are
unpacked unless the run keeps them, junk rows are trimmed or zero-extended
to what the mode allocates.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import time
from pathlib import Path
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from goctr_tpu_torch.core.dtypes import resolve_device
from goctr_tpu_torch.models.io import _flatten_params
from goctr_tpu_torch.models.trainer import TrainerConfig
from goctr_tpu_torch.ops.kernels.compact import compact_runsums_block
from goctr_tpu_torch.ops.kernels.row_gather import gather_rows
from goctr_tpu_torch.ops.kernels.row_optimizer import (
    LANES, ROWS_PER_STEP, apply_csum_updates, apply_line_updates,
    apply_line_updates_split, apply_row_updates, apply_row_updates_split,
    group_size, pack_grads, pack_table, pack_table_grouped, packed_lines,
    unpack_table, unpack_table_grouped, unpack_table_grouped_np,
)
from goctr_tpu_torch.ops.kernels.run_optimizer import apply_run_updates
from goctr_tpu_torch.ops.scatter import scatter_add_rows
from goctr_tpu_torch.ops.segsum import (
    _cumsum_rows, segment_rows_dedup, sorted_run_sums,
)
from goctr_tpu_torch.optim.optimizers import Solver, make_solver
from goctr_tpu_torch.optim.schedules import make_schedule
from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
from goctr_tpu_torch.parallel.table_opt import TableOptConfig

if TYPE_CHECKING:       # sparse_trainer imports this module
    from goctr_tpu_torch.parallel.sparse_trainer import SparseSample

__all__ = ["TableOptConfig", "TrainedScanned", "train_sparse_scanned",
           "save_scanned_checkpoint", "load_scanned_checkpoint",
           "model_bytes_per_example", "model_flops_per_example",
           "table_pad_rows", "GROUPED_RESIDENT_MIN_V"]

log = logging.getLogger(__name__)

# vocab from which a grouped (emb_dim <= 63) fused run keeps its table in
# line layout end to end: fresh lines drawn directly, lines returned
GROUPED_RESIDENT_MIN_V = 4_000_000
UPDATE_MODES = ("fused", "fused2", "runfused", "dedup", "sorted", "plain")
# weights and accumulator packed into 128-lane lines (emb_dim < 128)
PACKED_MODES = ("fused", "fused2", "runfused")


@dataclasses.dataclass
class TrainedScanned:
    model: SparseCTR                    # holds the dense parameters
    # [V, D] ([V + table_pad_rows, D] from dedup), or grouped [L, 128]
    table: torch.Tensor
    loss_curve: list[float]
    epoch_times: list[float] = dataclasses.field(default_factory=list)
    # solver state leaves in JAX leaf order (optim/optimizers.py)
    opt_state: Optional[list[torch.Tensor]] = dataclasses.field(
        default=None, repr=False)
    acc: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                    repr=False)
    # max per-batch count of unique rows dropped by compact_cap (0 = every
    # batch fit; if ever nonzero, grow the cap)
    update_overflow_max: int = 0
    # >1: `table` is grouped packed lines [ceil(V/G), 128], acc None
    packed_group: int = 1

    def rows_of(self, ids: torch.Tensor) -> torch.Tensor:
        """Embedding rows of `ids` in the compute dtype (kernel K1)."""
        return gather_rows(self.table, ids, group=self.packed_group,
                           dim=self.model.emb_dim,
                           out_dtype=self.model.compute_dtype)

    @torch.inference_mode()
    def predict(self, sample: SparseSample, batch_size: int = 32768
                ) -> np.ndarray:
        """Click probabilities [N] for `sample`, on the table's device."""
        dev = self.table.device
        n = sample.rows
        out = np.empty(n, np.float32)
        bs = min(batch_size, n)
        prof = sample.user_profile.astype(np.float32, copy=False)
        bids_all = sample.behavior_ids.astype(np.int32, copy=False)
        iids_all = sample.item_ids.astype(np.int32, copy=False)
        ctx = sample.ctx.astype(np.float32, copy=False)
        for s in range(0, n, bs):
            e = min(s + bs, n)
            pad = bs - (e - s)

            def p(a, fill=0):
                x = a[s:e]
                if pad:
                    x = np.concatenate(
                        [x, np.full((pad,) + x.shape[1:], fill, x.dtype)])
                return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

            bids = p(bids_all, -1)
            emb_b = self.rows_of(bids.clamp_min(0))
            emb_i = self.rows_of(p(iids_all))
            mask = (bids >= 0).float()
            logits = self.model.apply_pooled(p(prof), emb_b, emb_i, p(ctx),
                                             mask)
            out[s:e] = torch.sigmoid(logits).cpu().numpy()[:e - s]
        return out


def table_pad_rows(batch_size: int, behavior_len: int) -> int:
    """Junk rows the `dedup` mode allocates past the vocab: one shared
    row for the -1 pads + a distinct target per update position (n
    rounded up to ROWS_PER_STEP) + margin. The packed modes allocate
    none: their junk targets are skipped by the row update."""
    n = batch_size * (behavior_len + 1)
    n = -(-n // ROWS_PER_STEP) * ROWS_PER_STEP
    return n + 2


def table_group(update_mode: str, emb_dim: int) -> int:
    """Rows a line of the table the trainer updates in `update_mode`: G =
    group_size(emb_dim) only for `fused` (scanned.py:470); one row a line
    (or a row of [V, D]) in every other mode."""
    return group_size(emb_dim) if update_mode == "fused" else 1


def _check_supported(topt: TableOptConfig, emb_dim: int) -> None:
    """The JAX trainer's errors (scanned.py:398-399, :239-240, :462-466),
    raised before the first epoch, and the port's own option checks."""
    if topt.kind not in ("adagrad", "sgd"):
        raise ValueError(f"unknown table optimizer {topt.kind!r}")
    if topt.update_mode not in UPDATE_MODES:
        raise ValueError(f"unknown update_mode {topt.update_mode!r}")
    if topt.update_mode in PACKED_MODES and emb_dim >= LANES:
        raise ValueError(f"update_mode={topt.update_mode!r} requires "
                         "emb_dim < 128 (weights+acc pack into one "
                         "128-lane row)")
    if topt.rmw_impl not in ("split", "kernel"):
        raise ValueError(f"unknown rmw_impl {topt.rmw_impl!r}")
    if topt.compact_impl not in ("xla", "kernel"):
        raise ValueError(f"unknown compact_impl {topt.compact_impl!r}")


def _compact_xla(s_ids: torch.Tensor, g_s: torch.Tensor, vocab: int,
                 capr: int):
    """The JAX trainer's rank-sort compaction (scanned.py:296-311): run
    sums as differences of consecutive run-end cumsum rows, the first capr
    real run ends selected by one stable sort."""
    n, d = g_s.shape
    dev = g_s.device
    c = _cumsum_rows(g_s)
    is_end = torch.cat([s_ids[1:] != s_ids[:-1],
                        torch.ones(1, dtype=torch.bool, device=dev)])
    real_end = is_end & (s_ids < vocab)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    sel = torch.sort(torch.where(real_end, pos, n + pos),
                     stable=True).indices[:capr]
    sel_real = real_end[sel]
    c_sel = c[sel]
    prev = torch.cat([c_sel.new_zeros((1, d)), c_sel[:-1]])
    rows = torch.where(sel_real[:, None], c_sel - prev, 0.0)
    tgt = torch.where(sel_real, s_ids[sel], vocab + 1 + pos[:capr])
    overflow = torch.clamp(real_end.sum() - capr, min=0).to(torch.int32)
    return tgt.to(torch.int32), rows, overflow


def sort_updates(ids_flat: torch.Tensor, g_flat: torch.Tensor,
                 vocab: int):
    """The compaction front end's sorted stream: pads (-1) become id
    `vocab` with zero rows, the stream is padded to a multiple of
    ROWS_PER_STEP with the same, and a stable sort orders it by id.
    Returns (s_ids [n_to] int32, g_s [n_to, D] f32)."""
    n0, d = g_flat.shape
    n_to = -(-n0 // ROWS_PER_STEP) * ROWS_PER_STEP
    valid = ids_flat >= 0
    g_flat = g_flat * valid[:, None].to(g_flat.dtype)
    ids_clean = torch.where(valid, ids_flat, vocab)
    if n_to > n0:
        ids_clean = torch.cat([ids_clean, torch.full(
            (n_to - n0,), vocab, dtype=ids_clean.dtype,
            device=ids_clean.device)])
        g_flat = torch.cat([g_flat, g_flat.new_zeros((n_to - n0, d))])
    order = torch.sort(ids_clean, stable=True).indices
    return ids_clean[order], g_flat[order]


def compact_slots(compact_cap: int, n_to: int) -> int:
    """Slots of the compacted stream: the cap rounded up to ROWS_PER_STEP,
    at most the padded stream's length (scanned.py:286-287)."""
    return min(-(-compact_cap // ROWS_PER_STEP) * ROWS_PER_STEP, n_to)


def update_rows(ids_flat: torch.Tensor, g_flat: torch.Tensor,
                topt: TableOptConfig, vocab: int):
    """One batch's row gradients summed per id by the front end: (tgt [m]
    int32, pairwise distinct below vocab, junk targets past it; rows
    [m, D] f32, each real target's Σg and zeros elsewhere; packed, the
    [m, 128] (Σg | ‖Σg‖² | 0) rows where the front end makes them (K9),
    else None; overflow, the int32 count of unique rows the compaction
    cap dropped, on the device). ids_flat [n] int32 (-1 = behavior pad,
    contributes nothing), g_flat [n, D] f32."""
    n0, d = g_flat.shape
    n_to = -(-n0 // ROWS_PER_STEP) * ROWS_PER_STEP
    if not topt.compact_cap:
        tgt, rows = segment_rows_dedup(ids_flat, g_flat, vocab, pad_to=n_to)
        return tgt, rows, None, torch.zeros(
            (), dtype=torch.int32, device=g_flat.device)
    s_ids, g_s = sort_updates(ids_flat, g_flat, vocab)
    capr = compact_slots(topt.compact_cap, n_to)
    if topt.compact_impl == "kernel":
        # the JAX trainer takes the kernel only for vocab < 2^24 because
        # its ids ride an f32 matmul on the TPU; K9 keeps ids in int32, so
        # only its D < 127 holds here (it raises otherwise, as JAX does)
        tgt, packed, overflow = compact_runsums_block(s_ids, g_s, vocab,
                                                      capr)
        return tgt, packed[:, :d], packed, overflow
    tgt, rows, overflow = _compact_xla(s_ids, g_s, vocab, capr)
    return tgt, rows, None, overflow


def line_stream(tgt: torch.Tensor, rows: torch.Tensor, vocab: int):
    """The grouped lines' update stream (scanned.py:346-361): each real
    row's (Σg | ‖Σg‖²) placed in its group's lanes of a [m, 128] row, rows
    keyed by their line tgt // G (junk rows by L + position), sorted
    stably, and the rows of one line summed (`sorted_run_sums`). Returns
    (line ids [m] int32, pairwise distinct below L, junk ids from
    L + m + 1; lane-placed line updates [m, 128] f32). ‖Σg‖² is
    recomputed from the D weight lanes, as the JAX trainer does (:349),
    whatever lane D of a packed front end holds."""
    m, d = rows.shape
    g = group_size(d)
    n_lines = packed_lines(vocab, d)
    dev = rows.device
    real = tgt < vocab
    nsq = (rows * rows).sum(1, keepdim=True)
    vals = torch.cat([rows, nsq], 1) * real[:, None].float()
    cols = (torch.remainder(tgt, g).long()[:, None] * (d + 1)
            + torch.arange(d + 1, device=dev))
    upd = torch.zeros((m, LANES), dtype=torch.float32, device=dev)
    upd.scatter_(1, cols, vals)
    pos = torch.arange(m, dtype=torch.int32, device=dev)
    lkey = torch.where(real, torch.div(tgt, g, rounding_mode="floor"),
                       n_lines + pos).to(torch.int32)
    order = torch.sort(lkey, stable=True).indices
    return sorted_run_sums(lkey[order], upd[order],
                           junk_base=n_lines + m + 1)


def _scatter_update(table: torch.Tensor, acc: torch.Tensor,
                    ids_flat: torch.Tensor, g_flat: torch.Tensor,
                    topt: TableOptConfig, vocab: int) -> None:
    """The unpacked modes (scanned.py:161-187, :367-380), in place on the
    [rows, D] table and its [rows] accumulator, with `scatter_add_rows`
    (ids in the table, each id's adds in stream order) where JAX
    scatters:
      plain  — the batch's stream as it is (pads add zero rows to row 0);
      sorted — the stably sorted stream (pads, -1, dropped);
      dedup  — each id's rows summed (segment_rows_dedup, junk targets
               V+1+k inside the table's junk rows), one row per id;
    then acc += ‖g‖² of each row of the stream, and each row scaled by
    lr · rsqrt(acc[id] + eps) (adagrad, after all the stream's acc adds)
    or lr (sgd) is subtracted at its id. Rows of negative ids (behavior
    pads) are zero."""
    g = g_flat * (ids_flat >= 0).float()[:, None]
    if topt.update_mode == "plain":
        tgt, rows = ids_flat.clamp_min(0), g
    elif topt.update_mode == "sorted":
        order = torch.sort(ids_flat, stable=True).indices
        tgt, rows = ids_flat[order], g[order]
    else:
        n0 = ids_flat.shape[0]
        tgt, rows = segment_rows_dedup(
            ids_flat, g, vocab, pad_to=-(-n0 // ROWS_PER_STEP) * ROWS_PER_STEP)
    if topt.kind == "adagrad":
        scatter_add_rows(acc[:, None], tgt, (rows * rows).sum(1)[:, None])
        scale = topt.lr * torch.rsqrt(acc[tgt.clamp_min(0).long()]
                                      + topt.eps)
    else:
        scale = torch.full(tgt.shape, topt.lr, device=g.device)
    scatter_add_rows(table, tgt, -scale[:, None] * rows)


def _table_update(table: torch.Tensor, ids_flat: torch.Tensor,
                  g_flat: torch.Tensor, topt: TableOptConfig, vocab: int,
                  acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply one batch's row gradients to the table in place, as
    `topt.update_mode` says (module docstring): fused on packed [V, 128]
    rows at G = 1 (split, or kernel K5) or grouped [L, 128] lines below
    (`line_stream`, then split or kernel K6); fused2 (K7) and runfused
    (K8) on packed [V, 128] rows; dedup, sorted and plain on the [rows, D]
    table and its accumulator `acc`. Returns the overflow count (0 but
    with compact_cap > 0 in fused), on the device."""
    d = g_flat.shape[1]
    mode = topt.update_mode
    if mode not in PACKED_MODES:
        _scatter_update(table, acc, ids_flat, g_flat, topt, vocab)
        return torch.zeros((), dtype=torch.int32, device=g_flat.device)
    kw = dict(lr=topt.lr, d=d, kind=topt.kind, eps=topt.eps)
    if mode != "fused":
        # sorted stream, pads = vocab last; compact_cap and rmw_impl do not
        # apply, as in JAX
        s_ids, g_s = sort_updates(ids_flat, g_flat, vocab)
        if mode == "fused2":
            apply_csum_updates(table, s_ids, _cumsum_rows(g_s), skip_ge=vocab,
                               **kw)
        else:
            apply_run_updates(table, s_ids, g_s, skip_ge=vocab, **kw)
        return torch.zeros((), dtype=torch.int32, device=g_flat.device)
    tgt, rows, packed, overflow = update_rows(ids_flat, g_flat, topt, vocab)
    kernel = topt.rmw_impl == "kernel"
    if group_size(d) == 1:
        gp = packed if packed is not None else pack_grads(rows)
        impl = apply_row_updates if kernel else apply_row_updates_split
        impl(table, tgt, gp, skip_ge=vocab, **kw)
    else:
        ltgt, lrows = line_stream(tgt, rows, vocab)
        impl = apply_line_updates if kernel else apply_line_updates_split
        impl(table, ltgt, lrows, skip_ge=packed_lines(vocab, d), **kw)
    return overflow


def bce_loss(logits: torch.Tensor, y: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """Weighted mean of the stable BCE-with-logits (scanned.py:513-515)."""
    losses = (torch.clamp(logits, min=0) - logits * y
              + torch.log1p(torch.exp(-torch.abs(logits))))
    return (losses * w).sum() / torch.clamp(w.sum(), min=1.0)


def make_trainer_solver(cfg: TrainerConfig) -> Solver:
    """The dense-parameter solver the scanned trainer uses for `cfg`."""
    schedule = make_schedule(cfg.lr_schedule, cfg.lr, cfg.power_t)
    return make_solver(cfg.solver, schedule, l2=cfg.l2,
                       weight_decay=cfg.weight_decay, momentum=cfg.momentum,
                       beta1=cfg.beta1, beta2=cfg.beta2, epsilon=cfg.epsilon)


def trainer_generator(cfg: TrainerConfig, epochs_done: int,
                      device: torch.device) -> torch.Generator:
    """The generator of a run that starts after `epochs_done` epochs:
    it draws the fresh parameters (when not resuming), then each epoch's
    permutation and the dropout masks."""
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed * 1_000_003 + epochs_done)
    return gen


def epoch_order(gen: torch.Generator, n_pad: int, shuffle: bool,
                device: torch.device) -> torch.Tensor:
    """One epoch's example order: a permutation of the padded dataset."""
    if shuffle:
        return torch.randperm(n_pad, generator=gen, device=device)
    return torch.arange(n_pad, device=device)


def gather_batch_rows(model: SparseCTR, table: torch.Tensor,
                      b_bids: torch.Tensor, b_iids: torch.Tensor,
                      sorted_gather: bool, group: int = 1) -> torch.Tensor:
    """The rows of one batch's ids, [B·T + B, D] in the compute dtype:
    behaviors (pads read row 0, masked later) then items, gathered by K1
    from the trainer's table (`group` rows per line: 1 for [V, 128] rows
    and [rows, D] tables, G for grouped lines), in raw or ascending-id
    order."""
    flat = torch.cat([b_bids.reshape(-1), b_iids])
    kw = dict(group=group, dim=model.emb_dim, out_dtype=model.compute_dtype)
    if not sorted_gather:
        return gather_rows(table, flat.clamp_min(0), **kw)
    order = torch.sort(flat, stable=True).indices
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return gather_rows(table, flat[order].clamp_min(0), **kw)[inv]


def batch_loss(model: SparseCTR, emb: torch.Tensor, b_prof, b_bids, b_ctx,
               b_y, b_w, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
    """The training loss of one batch over its gathered rows `emb`
    ([B·T + B, D], as gather_batch_rows returns them)."""
    bs, t = b_bids.shape
    nb = bs * t
    emb_b = emb[:nb].view(bs, t, model.emb_dim)
    emb_i = emb[nb:]
    mask = (b_bids >= 0).float()
    logits = model.apply_pooled(b_prof, emb_b, emb_i, b_ctx, mask,
                                train=True, generator=generator)
    return bce_loss(logits, b_y, b_w)


def train_step(model: SparseCTR, table: torch.Tensor, solver: Solver,
               opt_state: list[torch.Tensor], b_prof, b_bids, b_iids, b_ctx,
               b_y, b_w, topt: TableOptConfig,
               generator: Optional[torch.Generator] = None,
               acc: Optional[torch.Tensor] = None):
    """One step of the scanned trainer on one batch: gather the rows (K1),
    differentiate the loss with respect to the dense parameters and the
    gathered rows (K2 forward, K2b backward), take a solver step on the
    dense parameters in place, and update the table (and, in the modes
    that keep it apart, the accumulator `acc`) in place. The table is in
    the layout of topt.update_mode (module docstring): grouped lines of
    `table_group` rows, [V, 128] rows, or [rows, D]. Returns (loss,
    overflow, new solver state); nothing syncs the host."""
    params = model.param_leaves()
    with torch.enable_grad():
        emb = gather_batch_rows(
            model, table, b_bids, b_iids, topt.sorted_gather,
            table_group(topt.update_mode, model.emb_dim)).requires_grad_()
        loss = batch_loss(model, emb, b_prof, b_bids, b_ctx, b_y, b_w,
                          generator)
        *g_dense, g_emb = torch.autograd.grad(loss, params + [emb])
    updates, opt_state = solver.update(g_dense, opt_state, params)
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u)
        ids_flat = torch.cat([b_bids.reshape(-1), b_iids])
        overflow = _table_update(table, ids_flat, g_emb.float(), topt,
                                 model.item_vocab, acc)
    return loss.detach(), overflow, opt_state


def train_sparse_scanned(model: SparseCTR, sample: SparseSample,
                         cfg: Optional[TrainerConfig] = None,
                         table_opt: Optional[TableOptConfig] = None,
                         resume_from: Optional[TrainedScanned] = None,
                         device: str | torch.device = "cuda",
                         ) -> TrainedScanned:
    """Single-device scanned training of `model` on `sample`.

    Without resume_from the dense parameters and a fresh table are drawn
    from the run's generator: [V, D] N(0, 0.01²) (then laid out for the
    update mode), or for a grouped `fused` run at a vocab of
    GROUPED_RESIDENT_MIN_V or more, grouped lines drawn directly. With
    it, training continues from its dense parameters (copied into
    `model`), table (a [V, D] table with its adagrad accumulator, a dedup
    result's [V + pad, D], or grouped lines), and solver state;
    resume_from itself is not modified (unless it shares `model`):
    tables are copied, a transient second copy (7.3 GB of lines at 100M ×
    16) where the JAX trainer donates them. `model` is moved to `device`
    and its parameters are trained in place. The result's table is fresh:
    the grouped lines ([L, 128], packed_group = G, acc None) of a resident
    grouped `fused` run, else a contiguous [rows, D] tensor and its
    [rows] acc, rows = V + table_pad_rows in dedup and V otherwise."""
    cfg = cfg or TrainerConfig()
    topt = table_opt or TableOptConfig()
    d, v = model.emb_dim, model.item_vocab
    _check_supported(topt, d)
    dev = resolve_device(device)
    model.to(dev)
    n = sample.rows
    bs = min(cfg.batch_size, n)
    n_batches = -(-n // bs)
    n_pad = n_batches * bs

    # ---- device-resident dataset (padded tail rows carry weight 0) -------
    def pad_rows(a: np.ndarray, fill=0) -> torch.Tensor:
        if n_pad > n:
            a = np.concatenate(
                [a, np.full((n_pad - n,) + a.shape[1:], fill, a.dtype)])
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    d_prof = pad_rows(sample.user_profile.astype(np.float32))
    d_bids = pad_rows(sample.behavior_ids.astype(np.int32), fill=-1)
    d_iids = pad_rows(sample.item_ids.astype(np.int32))
    d_ctx = pad_rows(sample.ctx.astype(np.float32))
    d_y = pad_rows(np.asarray(sample.labels, np.float32).ravel())
    d_w = torch.cat([torch.ones(n, device=dev),
                     torch.zeros(n_pad - n, device=dev)])

    # ---- params: dense tower via the solver, table via row updates -------
    n_prev = len(resume_from.loss_curve) if resume_from is not None else 0
    gen = trainer_generator(cfg, n_prev, dev)
    mode = topt.update_mode
    g = table_group(mode, d)
    resident = g > 1 and v >= GROUPED_RESIDENT_MIN_V
    rows = v + (table_pad_rows(bs, sample.behavior_ids.shape[1])
                if mode == "dedup" else 0)
    # the table (and acc) as the trainer updates them, fresh tensors
    if resume_from is not None:
        if resume_from.model is not model:
            model.load_state_dict(resume_from.model.state_dict())
        if resume_from.packed_group not in (1, group_size(d)):
            raise ValueError(
                f"resume_from holds lines of {resume_from.packed_group} "
                f"rows; emb_dim {d} packs {group_size(d)}")
        if resume_from.packed_group > 1 and g > 1:
            table, acc = resume_from.table.to(dev, copy=True), None
        else:
            if resume_from.packed_group > 1:    # lines into another mode
                w, a = unpack_table_grouped(resume_from.table.to(dev), v, d)
            else:
                w = resume_from.table.to(dev)
                a = (resume_from.acc.to(dev) if resume_from.acc is not None
                     else torch.zeros(w.shape[0], device=dev))
            table, acc = _layout_table(mode, w, a, v, rows)
            del w, a
    elif resident:
        table, acc = model.init_params(gen, table_group=g), None
    else:
        w = model.init_params(gen)
        table, acc = _layout_table(mode, w, torch.zeros(v, device=dev), v,
                                   rows)
        del w

    params = model.param_leaves()
    solver = make_trainer_solver(cfg)
    if resume_from is not None and resume_from.opt_state is not None:
        opt_state = [x.to(dev) for x in resume_from.opt_state]
        _check_opt_state(opt_state, solver.init(params))
    else:
        opt_state = solver.init(params)

    best, no_improve = float("inf"), 0
    update_overflow_max = 0
    loss_curve: list[float] = []
    epoch_times: list[float] = []
    for epoch in range(cfg.epochs):
        te = time.perf_counter()
        perm = epoch_order(gen, n_pad, cfg.shuffle, dev)
        losses, overs = [], []
        for b in range(n_batches):
            idx = perm[b * bs:(b + 1) * bs]
            loss, over, opt_state = train_step(
                model, table, solver, opt_state, d_prof[idx], d_bids[idx],
                d_iids[idx], d_ctx[idx], d_y[idx], d_w[idx], topt, gen, acc)
            losses.append(loss)
            overs.append(over)
        # the epoch's one host sync: mean loss and max overflow together
        cost, over = torch.stack([torch.stack(losses).mean(),
                                  torch.stack(overs).max().float()]).tolist()
        over = int(over)
        if over > update_overflow_max:
            update_overflow_max = over
            log.warning(
                "fused compact_cap overflow: %d unique rows dropped in a "
                "batch — raise TableOptConfig.compact_cap (currently %d)",
                over, topt.compact_cap)
        epoch_times.append(time.perf_counter() - te)
        loss_curve.append(cost)
        if cfg.verbose:
            log.info("epoch %d | cost %.6f | %.2fs", epoch, cost,
                     epoch_times[-1])
        if cost < best - cfg.tol:
            best, no_improve = cost, 0
        else:
            no_improve += 1
        if cfg.early_stop and no_improve >= cfg.early_stop:
            break

    if resume_from is not None:
        loss_curve = resume_from.loss_curve + loss_curve
    if mode == "fused" and not resident:   # K1 takes contiguous tables only
        table, acc = (x.contiguous()
                      for x in unpack_table_grouped(table, v, d))
    elif mode in PACKED_MODES and not resident:     # one row a line
        table, acc = (x.contiguous() for x in unpack_table(table, d))
    return TrainedScanned(model=model, table=table, loss_curve=loss_curve,
                          epoch_times=epoch_times, opt_state=opt_state,
                          acc=acc, update_overflow_max=update_overflow_max,
                          packed_group=g if resident else 1)


def _layout_table(mode: str, weights: torch.Tensor, acc: torch.Tensor,
                  vocab: int, rows: int):
    """(table, acc) as the trainer of `mode` updates them, fresh tensors
    made from [V', D] weights and their [V'] accumulator: `fused` packs
    the first V rows into [V, 128] rows or grouped lines, fused2 and
    runfused into [V, 128] rows at every D (acc None: it lives in the
    lines); the other modes keep [rows, D] and [rows], dropping rows past
    `rows` and zero-filling missing ones (dedup's junk rows)."""
    if mode == "fused":
        return pack_table_grouped(weights[:vocab], acc[:vocab]), None
    if mode in PACKED_MODES:
        return pack_table(weights[:vocab], acc[:vocab]), None
    out_w = weights.new_zeros((rows, weights.shape[1]))
    out_a = acc.new_zeros((rows,))
    out_w[:weights.shape[0]] = weights[:rows]
    out_a[:acc.shape[0]] = acc[:rows]
    return out_w, out_a


def _check_opt_state(state: list[torch.Tensor],
                     template: list[torch.Tensor]) -> None:
    if len(state) != len(template) or any(
            tuple(s.shape) != tuple(t.shape) for s, t in zip(state, template)):
        raise ValueError(
            "solver state does not match the trainer's solver: "
            f"{[tuple(s.shape) for s in state]} vs "
            f"{[tuple(t.shape) for t in template]}")


def save_scanned_checkpoint(path, trained: TrainedScanned,
                            trainer_config=None) -> None:
    """Write meta.json, dense.npz, table.npz and (when the result has a
    solver state) opt_state.npz. `trainer_config` is a TrainerConfig, a
    dict of its fields, or None; the JAX loader restores the solver state
    only when it is given."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    m = trained.model
    if dataclasses.is_dataclass(trainer_config):
        trainer_config = dataclasses.asdict(trainer_config)
    meta = {"model_config": m.config(), "loss_curve": trained.loss_curve,
            "trainer_config": trainer_config}
    (path / "meta.json").write_text(json.dumps(meta))
    np.savez(path / "dense.npz", **_flatten_params(m.state_dict()))
    # checkpoints carry exactly the vocab
    v = m.item_vocab
    if trained.packed_group > 1:
        w, a = unpack_table_grouped_np(trained.table.cpu().numpy(), v,
                                       m.emb_dim)
        np.savez(path / "table.npz", table=w, acc=a)
    else:
        acc = (trained.acc[:v].cpu().numpy() if trained.acc is not None
               else np.zeros(0, np.float32))
        np.savez(path / "table.npz", table=trained.table[:v].cpu().numpy(),
                 acc=acc)
    if trained.opt_state is not None:
        np.savez(path / "opt_state.npz",
                 **{str(i): x.cpu().numpy()
                    for i, x in enumerate(trained.opt_state)})


def load_scanned_checkpoint(path, device: str | torch.device = "cuda"
                            ) -> TrainedScanned:
    """Load a scanned checkpoint written by either package onto
    `device`. The model computes in float32: the checkpoint, like the JAX
    package's, does not record the compute dtype. The solver state is
    loaded whenever opt_state.npz exists, and checked against the
    checkpoint's trainer config when it has one (the JAX loader skips the
    state without a trainer config, ROADMAP C)."""
    dev = resolve_device(device)
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    mc = dict(meta["model_config"])
    mc["hidden"] = tuple(mc["hidden"])
    model = SparseCTR(**mc, device=dev)
    with np.load(path / "dense.npz") as z:
        model.load_state_dict({k: torch.from_numpy(z[k]) for k in z.files})
    with np.load(path / "table.npz") as z:
        table = torch.from_numpy(z["table"]).to(dev, torch.float32)
        acc = (torch.from_numpy(z["acc"]).to(dev) if z["acc"].size
               else None)
    opt_state = None
    opt_path = path / "opt_state.npz"
    if opt_path.exists():
        with np.load(opt_path) as z:
            opt_state = [torch.from_numpy(np.array(z[str(i)])).to(dev)
                         for i in range(len(z.files))]
        tc = meta.get("trainer_config")
        if tc is not None:
            _check_opt_state(opt_state, make_trainer_solver(
                TrainerConfig(**tc)).init(model.param_leaves()))
    return TrainedScanned(model=model, table=table,
                          loss_curve=meta["loss_curve"], opt_state=opt_state,
                          acc=acc)


def model_bytes_per_example(model: SparseCTR, T: int,
                            update_mode: str = "dedup",
                            real_frac: float = 1.0,
                            compact_frac: float = 0.0) -> float:
    """Analytic device-memory bytes per example of the scanned trainer (f32
    table), as the JAX package counts them: embedding gather (T+1 rows),
    the row update of the same rows, accumulator traffic, the dataset-row
    gather, and the dedup pipeline's own streams (id sort, row permute,
    cumsum, boundary gather, grad packing)."""
    D = model.emb_dim
    row = D * 4.0
    packed = 128.0 * 4.0                    # packed 128-lane rows (w|acc|pad)
    rows = T + 1.0
    is_packed = update_mode in ("fused", "runfused", "fused2")
    gather = rows * (packed if is_packed else row)
    scatter = 2.0 * rows * (packed if is_packed else row)
    if is_packed:
        # only real (unique-id) targets move a read/write pair; junk rows
        # are skipped. real_frac = uniques / rows (workload-dependent)
        scatter *= real_frac
    acc = 0.0 if is_packed else rows * 4.0 * 3.0
    dataset = (model.u_profile_dim + model.ctx_dim + 2) * 4.0 + T * 4.0
    pipeline = 0.0
    if update_mode == "sorted":
        pipeline = rows * (8.0 + 2.0 * row)
    elif update_mode == "runfused":
        pipeline = rows * (8.0 + 3.0 * row)
    elif update_mode == "fused2":
        pipeline = rows * (8.0 + 5.0 * row)
    elif update_mode == "fused" and compact_frac:
        # id sort + rank sort + row permute + cumsum; only the compact_frac
        # selected slots move the c_sel gather and the grad pack + stream
        pipeline = (rows * (16.0 + 4.0 * row)
                    + compact_frac * rows * (2.0 * row + 2.0 * packed))
    elif update_mode in ("dedup", "fused"):
        pipeline = rows * (8.0 + 7.0 * row)
        if update_mode == "fused":
            pipeline += rows * 2.0 * packed
    return gather + scatter + acc + dataset + pipeline


def model_flops_per_example(model: SparseCTR, T: int) -> float:
    """Analytic training FLOPs per example (fwd + bwd ≈ 3× fwd for the
    tower matmuls, plus the attention pool's vector ops; the embedding
    gather and scatter move bytes, not FLOPs)."""
    D = model.emb_dim
    dims = model.layer_dims
    macs = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    mlp_train = 6.0 * macs                       # 2 FLOPs/MAC × 3 (fwd+bwd)
    attn = 3.0 * (4.0 * T * D)                   # cos-sim + gate + pool
    return mlp_train + attn
