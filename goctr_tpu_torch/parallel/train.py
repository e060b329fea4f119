"""The mesh trainer's steps (port of goctr_tpu/parallel/train.py:
param_shardings / batch_shardings :32-47, make_sharded_train_step
:50-75, make_sharded_predict :78-86, _pad_to :89-96,
make_sharded_sparse_train_step :99-331).

Each rank runs the step on its data shard's rows of the global batch and
its model shard of the table (SPMD, where JAX writes one jitted step and
lets GSPMD or shard_map split it). On the 1×1 mesh every collective is
the identity and the steps are the single-device code.

Two steps, as in JAX:
  * the dense step: the item table is a parameter like the tower's. The
    loss is differentiated through `SparseCTR.apply` (K3's backward and
    the item gather's backward add into one table gradient) and one
    solver step moves every parameter, table included, in JAX leaf
    order (`dense_path_leaves`); l2 decays the table too. JAX's loss is
    the mean over the global batch and GSPMD sums the gradients over
    `data`: here each rank takes its rows' loss sum over the global batch
    size, and the loss and every gradient (the dense parameters' and the
    table shard's) are psummed over `data`, so every rank reports the
    global loss and takes the same dense update.
  * the sparse step: the table never enters autograd. The loss is
    differentiated with respect to the gathered rows (`apply_pooled`)
    and the table takes row-wise adagrad or sgd updates in the four
    stages of JAX's `table_update` (:186-302), kept as JAX writes them:
    1. each data shard compacts its chunk of the row gradients
       (`_compact_xla`), the dropped ids counted and summed over `data`
       only. JAX's stage 1 receives the flattened global stream
       [behaviors; items] cut into d chunks. Where a cap can drop ids
       (exchange_cap set, more than one data shard) the port all-gathers
       the raw stream over `data` and takes the same chunk, so it drops
       JAX's ids; without a cap nothing drops and each shard compacts its
       own rows (the same merged sums, added in another order);
    2. the compacted (ids, rows) are all-gathered over `data`;
    3. the d·cap stream is merged (one stable sort and run sums);
    4. each model shard masks the merged stream to its row range
       (`rel = tgt - shard * per_shard`) and updates its rows; the other
       ids become junk ids, pairwise distinct and at or above the local
       row count (`skip_ge`).

Stage 4 routes by update_mode as JAX's mesh step does, which is not the
scanned trainer's routing: fused at one row a line, fused2 and runfused
update packed [V, 128] rows through the fused row update (K5, or the
split update under rmw_impl="split"), not K7 / K8; fused on grouped
lines takes the lane placement, a second run sum over line ids and K6 or
the split line update; dedup, sorted and plain take one scatter pair
(row-wise adagrad over each id's summed gradient, an add into the table).

Parameters, the table and its accumulator are updated IN PLACE, where
the JAX steps return new arrays (they donate the old ones). A step
returns its loss (and overflow count) on the device. On the 1×1 mesh
the host never waits on the card in a step (chip_smoke.py's [sync]
phase and tests/test_torch_cuda.py run both steps under
torch.cuda.set_sync_debug_mode("error"), parallel/step_cases.py). On a
larger mesh the only waits are the collectives': over gloo each psum and
all_gather of a CUDA tensor is staged through pinned host memory
(core/meshes.py `_all_reduce`, `all_gather`), and the copy there and the
copy back each make the host wait; over NCCL they are enqueued on the
card's stream (not checked under the sync debug mode, which would need
a card a rank).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from goctr_tpu_torch.core.meshes import (
    DATA_AXIS, MODEL_AXIS, Mesh, Placement, all_gather, batch_sharded,
    psum, replicated, row_sharded,
)
from goctr_tpu_torch.ops.kernels.row_optimizer import (
    apply_line_updates, apply_line_updates_split, apply_row_updates,
    apply_row_updates_split, group_size, pack_grads,
)
from goctr_tpu_torch.ops.scatter import scatter_add_rows
from goctr_tpu_torch.ops.segsum import sorted_run_sums
from goctr_tpu_torch.optim.optimizers import Solver
from goctr_tpu_torch.parallel.embedding import sharded_lookup
from goctr_tpu_torch.parallel.scanned import (
    PACKED_MODES, _compact_xla, compact_slots, line_stream, sort_updates,
)
from goctr_tpu_torch.parallel.sparse_ctr import SparseBatch, SparseCTR
from goctr_tpu_torch.parallel.table_opt import TableOptConfig


def _bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(logits, min=0) - logits * y
            + torch.log1p(torch.exp(-torch.abs(logits))))


def mean_bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean stable BCE-with-logits over the batch, pad rows included, as
    the JAX mesh steps take it (ROADMAP C)."""
    return _bce(logits, y).mean()


def shard_loss(logits: torch.Tensor, y: torch.Tensor, mesh: Mesh
               ) -> torch.Tensor:
    """This data shard's part of the global batch's mean BCE: the mean
    itself on one data shard, else its rows' sum over the global batch
    size (the parts psum to the mean, their gradients to its gradient)."""
    if mesh.data == 1:
        return mean_bce(logits, y)
    return _bce(logits, y).sum() / (logits.shape[0] * mesh.data)


def psum_grads(grads: Sequence[torch.Tensor], mesh: Mesh,
               axis: str = DATA_AXIS) -> list[torch.Tensor]:
    """Each gradient summed over `axis`, in one collective."""
    grads = list(grads)
    if mesh.group(axis) is None or not grads:
        return grads
    flat = psum(torch.cat([g.reshape(-1).float() for g in grads]), mesh,
                axis)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
        at += g.numel()
    return out


def param_shardings(names: Sequence[str], mesh: Mesh
                    ) -> dict[str, Placement]:
    """Tables row-sharded over `model`; everything else replicated."""
    return {n: row_sharded(mesh) if "table" in n else replicated(mesh)
            for n in names}


def batch_shardings(mesh: Mesh) -> SparseBatch:
    """Every field of a batch split over `data` by rows."""
    p = batch_sharded(mesh)
    return SparseBatch(user_profile=p, behavior_ids=p, item_ids=p, ctx=p,
                       labels=p)


def local_batch(batch: SparseBatch, mesh: Mesh) -> SparseBatch:
    """This rank's rows of a global batch."""
    bsh = batch_shardings(mesh)
    return SparseBatch(**{k: getattr(bsh, k).local(getattr(batch, k))
                          for k in vars(batch)})


def dense_path_leaves(model: SparseCTR, table: torch.Tensor) -> list:
    """The dense step's parameters in JAX leaf order: att0, bias.*,
    item_table, mlp.* (the sorted keys of the JAX params dict), the order
    its solver state follows."""
    return [model.att0, *model.bias, table, *model.mlp]


def table_state_slots(model: SparseCTR, state: Sequence[torch.Tensor]
                      ) -> list[int]:
    """The positions of the item table's leaves (its moments) in a solver
    state of either package. A solver keeps, for each moment, one float
    leaf a parameter in leaf order (its step counts are integers): on the
    dense path, whose k leaves are dense_path_leaves, the table's are
    every k-th float leaf from the table's index there. The sparse path's
    state covers the k - 1 dense parameters alone and has none."""
    k = len(model.param_leaves()) + 1
    floats = [i for i, x in enumerate(state) if x.is_floating_point()]
    if len(floats) % k:
        return []
    return floats[1 + len(model.bias)::k]


def make_sharded_train_step(model: SparseCTR, solver: Solver, mesh: Mesh
                            ) -> Callable:
    """step(table, opt_state, batch, generator=None) → (loss, opt_state):
    one solver step on the dense parameters and the plain [V, D] `table`
    (this rank's model shard), in place (the table is made to require
    grad); `batch` is this rank's data shard, the loss the global one."""

    def step(table: torch.Tensor, opt_state: list, batch: SparseBatch,
             generator: Optional[torch.Generator] = None):
        leaves = dense_path_leaves(model, table.requires_grad_())
        with torch.enable_grad():
            logits = model.apply(table, batch, mesh, train=True,
                                 generator=generator)
            loss = shard_loss(logits, batch.labels, mesh)
            # att0 is unused under mean pooling: a zero gradient, as JAX's
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        grads = psum_grads(grads, mesh)
        loss = psum(loss.detach(), mesh, DATA_AXIS)
        updates, opt_state = solver.update(grads, opt_state, leaves)
        del grads
        with torch.no_grad():
            for p, u in zip(leaves, updates):
                p.add_(u)
        return loss.detach(), opt_state

    return step


def make_sharded_predict(model: SparseCTR, mesh: Mesh, table_group: int = 1,
                         table_packed: bool = False) -> Callable:
    """predict(table, batch) → click probabilities [B]."""

    @torch.inference_mode()
    def predict(table: torch.Tensor, batch: SparseBatch) -> torch.Tensor:
        return torch.sigmoid(model.apply(table, batch, mesh, train=False,
                                         table_group=table_group,
                                         table_packed=table_packed))

    return predict


def _pad_to(x: torch.Tensor, m: int, fill) -> torch.Tensor:
    """Pad dim 0 up to the next multiple of m."""
    n = x.shape[0]
    pad = -(-n // m) * m - n
    if not pad:
        return x
    return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])


def jax_chunk(x: torch.Tensor, n_b: int, mesh: Mesh) -> torch.Tensor:
    """This data shard's chunk of the global update stream as JAX's
    shard_map cuts it: x is this shard's [behaviors (n_b rows); items]
    stream; the global stream is every shard's behaviors, then every
    shard's items, in data order, split into d equal chunks."""
    parts = all_gather(x, mesh, DATA_AXIS).view(mesh.data, -1,
                                                *x.shape[1:])
    stream = torch.cat([parts[:, :n_b].flatten(0, 1),
                        parts[:, n_b:].flatten(0, 1)])
    return batch_sharded(mesh).local(stream)


def compact_stream(ids: torch.Tensor, grads: torch.Tensor, v: int,
                   cap: Optional[int]):
    """Stage 1 of the mesh's table update, on one data shard's flat row
    gradients (ids [n] int32, -1 pads; grads [n, D]): dedup + compact
    (pads → id v, padded to 1024, a stable sort, run sums as differences
    of run-end cumsum rows, the first `cap` run ends selected by a rank
    sort; cap None or 0: every slot). Its non-real slots carry junk ids
    past v where JAX's carry v: stage 3 sorts both after the real ids and
    gives them zero rows. Returns (ids, rows, dropped count)."""
    s_ids, g_s = sort_updates(ids, grads, v)
    return _compact_xla(s_ids, g_s, v,
                        compact_slots(cap or s_ids.shape[0], s_ids.shape[0]))


def shard_stream(u_ids: torch.Tensor, u_rows: torch.Tensor, v: int,
                 per_shard: int, shard: int, group: int, packed: bool):
    """Stages 3 and 4 of the mesh's table update: the data shards'
    compacted streams, gathered (u_ids [d·cap], u_rows [d·cap, D]), merged
    by id, and model shard `shard`'s update stream of them. The other
    shard's ids and the junk become distinct ids at or above the shard's
    row count, with zero rows. Returns (ids, rows, skip_ge): for packed
    lines (group > 1) `line_stream`'s line ids and [n, 128] rows; for
    packed rows local ids and `pack_grads` rows; else local ids and the
    [n, D] rows."""
    # ---- stage 3: merge duplicate ids across data shards
    u_ids, u_rows = _pad_to(u_ids, 1024, v), _pad_to(u_rows, 1024, 0.0)
    order = torch.sort(u_ids, stable=True).indices
    tgt, rows = sorted_run_sums(u_ids[order], u_rows[order], junk_base=v + 1)
    # ---- stage 4: this shard's rows
    rel = tgt - shard * per_shard
    mine = (tgt < v) & (rel >= 0) & (rel < per_shard)
    rows = torch.where(mine[:, None], rows, 0.0)
    if packed and group > 1:
        ltgt, lrows = line_stream(torch.where(mine, rel, per_shard), rows,
                                  per_shard)
        return ltgt, lrows, per_shard // group
    pos = torch.arange(tgt.shape[0], dtype=torch.int32, device=tgt.device)
    lid = torch.where(mine, rel, per_shard + 1 + pos).to(torch.int32)
    return lid, pack_grads(rows) if packed else rows, per_shard


def make_sharded_sparse_train_step(model: SparseCTR, solver: Solver,
                                   mesh: Mesh, topt: TableOptConfig
                                   ) -> Callable:
    """step(table, opt_state, acc, batch, generator=None) → (loss,
    opt_state, overflow): one solver step on the dense parameters and one
    row update of the table, in place. The table (this rank's model
    shard) is in the layout of topt.update_mode: packed [V, 128] rows
    (fused at emb_dim >= 64, fused2, runfused), grouped lines (fused
    below), or [V, D] with its [V] accumulator `acc` (the other modes);
    `batch` is this rank's data shard. `overflow` counts the unique ids
    lookup_dedup_cap and exchange_cap dropped, over every data shard."""
    d = model.emb_dim
    packed = topt.update_mode in PACKED_MODES
    g = group_size(d) if topt.update_mode == "fused" else 1
    width = d if packed else 0
    kw = dict(lr=topt.lr, d=d, kind=topt.kind, eps=topt.eps)

    def table_update(table: torch.Tensor, acc: Optional[torch.Tensor],
                     ids: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
        """ids [n] int32 (-1 pads), grads [n, D] f32: one batch's flat
        row gradients. Returns the overflow count."""
        per_shard = table.shape[0] * g             # rows on this shard
        v = per_shard * mesh.shape[MODEL_AXIS]     # padded vocab
        # ---- stage 1: dedup + compact
        u_ids, u_rows, over = compact_stream(ids, grads, v,
                                             topt.exchange_cap)
        # the ids are the same on every model shard: summing over data
        # alone gives the global dropped count (ADVICE r4)
        over = psum(over, mesh, DATA_AXIS)
        # ---- stage 2: all_gather of the compacted streams over `data`
        u_ids = all_gather(u_ids, mesh, DATA_AXIS)
        u_rows = all_gather(u_rows, mesh, DATA_AXIS)
        lid, rows, skip_ge = shard_stream(u_ids, u_rows, v, per_shard,
                                          mesh.index(MODEL_AXIS), g, packed)
        if packed:
            split = topt.rmw_impl == "split"
            if g > 1:
                impl = (apply_line_updates_split if split
                        else apply_line_updates)
            else:
                impl = apply_row_updates_split if split else apply_row_updates
            impl(table, lid, rows, skip_ge=skip_ge, **kw)
            return over
        if topt.kind == "adagrad":
            scatter_add_rows(acc[:, None], lid, (rows * rows).sum(1)[:, None])
            safe = lid.clamp(0, per_shard - 1).long()
            scale = topt.lr * torch.rsqrt(acc[safe] + topt.eps)
        else:
            scale = torch.full(lid.shape, topt.lr, device=rows.device)
        scatter_add_rows(table, lid, -scale[:, None] * rows)
        return over

    def step(table: torch.Tensor, opt_state: list,
             acc: Optional[torch.Tensor], batch: SparseBatch,
             generator: Optional[torch.Generator] = None):
        params = model.param_leaves()
        cap = model.lookup_dedup_cap
        emb_b, over_b = sharded_lookup(table, batch.behavior_ids, mesh,
                                       dedup_cap=cap, with_overflow=True,
                                       width=width, group=g)
        emb_i, over_i = sharded_lookup(table, batch.item_ids, mesh,
                                       dedup_cap=cap, with_overflow=True,
                                       width=width, group=g)
        with torch.enable_grad():
            emb_b.requires_grad_()
            emb_i.requires_grad_()
            mask = (batch.behavior_ids >= 0).float()
            logits = model.apply_pooled(batch.user_profile, emb_b, emb_i,
                                        batch.ctx, mask, train=True,
                                        generator=generator)
            loss = shard_loss(logits, batch.labels, mesh)
            *g_dense, g_b, g_i = torch.autograd.grad(
                loss, params + [emb_b, emb_i], materialize_grads=True)
        g_dense = psum_grads(g_dense, mesh)
        loss = psum(loss.detach(), mesh, DATA_AXIS)
        updates, opt_state = solver.update(g_dense, opt_state, params)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.add_(u)
            ids_flat = torch.cat([batch.behavior_ids.reshape(-1),
                                  batch.item_ids])
            g_flat = torch.cat([g_b.reshape(-1, d), g_i]).float()
            if topt.exchange_cap and mesh.data > 1:
                n_b = batch.behavior_ids.numel()
                ids_flat = jax_chunk(ids_flat, n_b, mesh)
                g_flat = jax_chunk(g_flat, n_b, mesh)
            over = table_update(table, acc, ids_flat, g_flat)
        return loss, opt_state, over + over_b + over_i

    return step
