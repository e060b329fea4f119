"""The mesh trainer's steps on the 1×1 mesh (port of
goctr_tpu/parallel/train.py: make_sharded_train_step :50-75,
make_sharded_predict :78-86, _pad_to :89-96,
make_sharded_sparse_train_step :99-331).

Two steps, as in JAX:
  * the dense step: the item table is a parameter like the tower's. The
    loss is differentiated through `SparseCTR.apply` (K3's backward and
    the item gather's backward add into one [V, D] table gradient) and
    one solver step moves every parameter, table included, in JAX leaf
    order (`dense_path_leaves`); l2 decays the table too.
  * the sparse step: the table never enters autograd. The loss is
    differentiated with respect to the gathered rows (`apply_pooled`)
    and the table takes row-wise adagrad or sgd updates in the four
    stages of JAX's `table_update` (:186-302), kept as JAX writes them.
    The exchange points of a sharded mesh are marked: on one data shard
    the all_gather of stage 2 is the identity, and the one model shard
    owns every row in stage 4 (ROADMAP A5b brings the others).

Stage 4 routes by update_mode as JAX's mesh step does, which is not the
scanned trainer's routing: fused at one row a line, fused2 and runfused
update packed [V, 128] rows through the fused row update (K5, or the
split update under rmw_impl="split"), not K7 / K8; fused on grouped
lines takes the lane placement, a second run sum over line ids and K6 or
the split line update; dedup, sorted and plain take one scatter pair
(row-wise adagrad over each id's summed gradient, an add into the table).

Parameters, the table and its accumulator are updated IN PLACE, where
the JAX steps return new arrays (they donate the old ones). A step
returns its loss (and overflow count) on the device; nothing syncs the
host.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from goctr_tpu_torch.core.meshes import MODEL_AXIS, Mesh
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


def mean_bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean stable BCE-with-logits over the batch, pad rows included, as
    the JAX mesh steps take it (ROADMAP C)."""
    losses = (torch.clamp(logits, min=0) - logits * y
              + torch.log1p(torch.exp(-torch.abs(logits))))
    return losses.mean()


def dense_path_leaves(model: SparseCTR, table: torch.Tensor) -> list:
    """The dense step's parameters in JAX leaf order: att0, bias.*,
    item_table, mlp.* (the sorted keys of the JAX params dict), the order
    its solver state follows."""
    return [model.att0, *model.bias, table, *model.mlp]


def make_sharded_train_step(model: SparseCTR, solver: Solver, mesh: Mesh
                            ) -> Callable:
    """step(table, opt_state, batch, generator=None) → (loss, opt_state):
    one solver step on the dense parameters and the plain [V, D] `table`,
    in place (the table is made to require grad)."""

    def step(table: torch.Tensor, opt_state: list, batch: SparseBatch,
             generator: Optional[torch.Generator] = None):
        leaves = dense_path_leaves(model, table.requires_grad_())
        with torch.enable_grad():
            logits = model.apply(table, batch, mesh, train=True,
                                 generator=generator)
            loss = mean_bce(logits, batch.labels)
            # att0 is unused under mean pooling: a zero gradient, as JAX's
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
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


def make_sharded_sparse_train_step(model: SparseCTR, solver: Solver,
                                   mesh: Mesh, topt: TableOptConfig
                                   ) -> Callable:
    """step(table, opt_state, acc, batch, generator=None) → (loss,
    opt_state, overflow): one solver step on the dense parameters and one
    row update of the table, in place. The table is in the layout of
    topt.update_mode: packed [V, 128] rows (fused at emb_dim >= 64,
    fused2, runfused), grouped lines (fused below), or [V, D] with its [V]
    accumulator `acc` (the other modes). `overflow` counts the unique ids
    exchange_cap dropped."""
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
        # ---- stage 1: dedup + compact (pads → id v, padded to 1024, a
        # stable sort, run sums as differences of run-end cumsum rows, the
        # first `cap` run ends selected by a rank sort). Its non-real
        # slots carry junk ids past v where JAX's carry v: stage 3 sorts
        # both after the real ids and gives them zero rows.
        s_ids, g_s = sort_updates(ids, grads, v)
        cap = compact_slots(topt.exchange_cap or s_ids.shape[0],
                            s_ids.shape[0])
        u_ids, u_rows, over = _compact_xla(s_ids, g_s, v, cap)
        # ---- stage 2: all_gather of the compacted streams over `data`:
        # the identity on one data shard (ROADMAP A5b)
        # ---- stage 3: merge duplicate ids across data shards
        u_ids, u_rows = _pad_to(u_ids, 1024, v), _pad_to(u_rows, 1024, 0.0)
        order = torch.sort(u_ids, stable=True).indices
        tgt, rows = sorted_run_sums(u_ids[order], u_rows[order],
                                    junk_base=v + 1)
        # ---- stage 4: update this shard's rows (the one shard owns all)
        mine = tgt < v
        pos = torch.arange(tgt.shape[0], dtype=torch.int32,
                           device=tgt.device)
        rows = torch.where(mine[:, None], rows, 0.0)
        if packed and g > 1:
            ltgt, lrows = line_stream(tgt, rows, per_shard)
            impl = (apply_line_updates_split if topt.rmw_impl == "split"
                    else apply_line_updates)
            impl(table, ltgt, lrows, skip_ge=table.shape[0], **kw)
            return over
        lid = torch.where(mine, tgt, per_shard + 1 + pos).to(torch.int32)
        if packed:
            impl = (apply_row_updates_split if topt.rmw_impl == "split"
                    else apply_row_updates)
            impl(table, lid, pack_grads(rows), skip_ge=per_shard, **kw)
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
        emb_b = sharded_lookup(table, batch.behavior_ids, mesh,
                               dedup_cap=cap, width=width, group=g)
        emb_i = sharded_lookup(table, batch.item_ids, mesh, dedup_cap=cap,
                               width=width, group=g)
        with torch.enable_grad():
            emb_b.requires_grad_()
            emb_i.requires_grad_()
            mask = (batch.behavior_ids >= 0).float()
            logits = model.apply_pooled(batch.user_profile, emb_b, emb_i,
                                        batch.ctx, mask, train=True,
                                        generator=generator)
            loss = mean_bce(logits, batch.labels)
            *g_dense, g_b, g_i = torch.autograd.grad(
                loss, params + [emb_b, emb_i], materialize_grads=True)
        updates, opt_state = solver.update(g_dense, opt_state, params)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.add_(u)
            ids_flat = torch.cat([batch.behavior_ids.reshape(-1),
                                  batch.item_ids])
            g_flat = torch.cat([g_b.reshape(-1, d), g_i]).float()
            over = table_update(table, acc, ids_flat, g_flat)
        return loss.detach(), opt_state, over

    return step
