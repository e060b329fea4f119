"""Embedding lookups over the (data, model) mesh (port of
goctr_tpu/parallel/embedding.py: EmbeddingSpec :32-39, init_table :42-49,
_local_gather :65-92, _dedup_flat :99-117, sharded_lookup :120-199 and
sharded_pooled_lookup :202-241).

On the 1×1 mesh a lookup is a local gather: `lookup_dedup_cap` changes
nothing and the overflow count is 0, as in JAX. On a larger mesh each
rank holds its model shard's rows ([V/m, D] rows, or V/(m·G) grouped
lines) and its data shard's ids, and runs what JAX runs inside
`shard_map` for one device: the ids are masked to this shard's row range,
gathered from the local rows (zeros elsewhere) and summed over `model`
(`psum`: one non-zero row an id, so the sum is exact). With a dedup cap
each data shard first sorts its ids and exchanges only the <= cap unique
rows (`_dedup_flat`), and the ids past the cap are counted, summed over
`data` only (the ids are the same on every model shard).

The gathers are kernel K1 (ops/kernels/row_gather.py) on every layout:
plain [V, D] rows, packed [V, 128] rows (the first `width` lanes) and
grouped lines (`group` rows a line; K1 reads the row's lanes where JAX
takes the line and selects the slot, `_extract_group`). On a plain table
the gather is differentiable (`TableRows`: backward adds each row's
gradient at its id into a [V, D] gradient, the transpose of `jnp.take`);
the psum's backward is the identity, so each shard's rows get exactly
their own gradient rows, which the mesh trainer's dense path needs. Mean
pooling on one device is kernel K3 (`GatherPoolMean`); on a larger mesh
K3 sums the locally masked ids ("sum": out-of-shard ids become pads,
`GatherPoolSum`), the sums are psummed over `model` and divided by the
global count of valid ids, as JAX does. The sum pool on one device
gathers and sums.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from goctr_tpu_torch.core.meshes import (
    DATA_AXIS, MODEL_AXIS, Mesh, psum, row_sharded,
)
from goctr_tpu_torch.core.prng import randn_rows
from goctr_tpu_torch.ops.kernels.embedding_lookup import (
    fused_gather_pool, gather_pool_mean, table_grad)
from goctr_tpu_torch.ops.kernels.row_gather import gather_rows


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    name: str
    vocab: int
    dim: int


def init_table(generator: torch.Generator, spec: EmbeddingSpec,
               mesh: Optional[Mesh] = None, scale: float = 0.01,
               multiple: int = 1) -> torch.Tensor:
    """[vocab, dim] float32 N(0, scale²) on the generator's device; on a
    mesh with m > 1 model shards, this rank's rows of that draw with the
    vocab padded to a multiple of m·`multiple` rows (the rows past the
    vocab are zeros)."""
    m = mesh.shape[MODEL_AXIS] if mesh else 1
    if m == 1:
        table = torch.randn((spec.vocab, spec.dim), generator=generator,
                            dtype=torch.float32, device=generator.device)
        return table.mul_(scale)
    r0, per = row_sharded(mesh).span(spec.vocab, multiple)
    r0, r1 = min(r0, spec.vocab), min(r0 + per, spec.vocab)
    table = torch.zeros((per, spec.dim), dtype=torch.float32,
                        device=generator.device)
    table[:r1 - r0] = randn_rows(generator, (spec.vocab, spec.dim), r0, r1)
    return table.mul_(scale)


class TableRows(torch.autograd.Function):
    """table[ids] of a plain [V, D] table through K1 (NaN rows for ids >=
    V, as `jnp.take`); backward: the rows' gradients added at their ids
    into a [V, D] gradient, ids past the table dropped (`index_add_`: on
    the card a hot id's rows add in an order that is not fixed)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return gather_rows(table, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return table_grad(ids, g, ctx.n_rows), None


class GatherPoolSum(torch.autograd.Function):
    """Trainable sum-pool lookup of a plain table: table [V, D], ids [B, K]
    (-1 pads) → [B, D]; forward K3 with "sum", backward each valid
    position's row gets g[b], added into a [V, D] gradient."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return fused_gather_pool(table, ids, "sum")

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        rows = g[:, None, :].expand(-1, ids.shape[1], -1)
        return table_grad(ids, rows, ctx.n_rows), None


def _gather(table: torch.Tensor, ids: torch.Tensor, width: int,
            group: int) -> torch.Tensor:
    """K1 on any layout; differentiable for a plain table."""
    if group == 1 and not width:
        return TableRows.apply(table, ids)
    return gather_rows(table, ids, group=group, dim=width)


def _local_gather(local_rows: torch.Tensor, ids: torch.Tensor, mesh: Mesh,
                  width: int = 0, group: int = 1) -> torch.Tensor:
    """The rows of ids (>= 0) from this model shard's row range, zeros
    for the ids of other shards, summed over `model`. local_rows holds
    local_rows.shape[0]·group rows (grouped lines: `group` rows a line);
    width > 0 takes each packed row's first `width` lanes before the
    psum."""
    per = local_rows.shape[0] * group
    local = ids - mesh.index(MODEL_AXIS) * per
    valid = (local >= 0) & (local < per)
    emb = _gather(local_rows, torch.where(valid, local, 0), width, group)
    return psum(torch.where(valid[..., None], emb, 0.0), mesh, MODEL_AXIS)


def _dedup_flat(flat: torch.Tensor, cap: int):
    """Static-shape batch dedup: (uniq [cap] — the unique ids ascending,
    -1 padded; inv [n] — the slot of each position; n_unique — their
    count). Slots past the cap are dropped from uniq (callers clip inv),
    as in JAX: they all write one extra slot, which is cut, so no shape
    depends on the data and the host does not wait on the card. Every
    other slot is written only with its one id."""
    s, order = torch.sort(flat, stable=True)
    new = torch.cat([torch.ones(1, dtype=torch.bool, device=flat.device),
                     s[1:] != s[:-1]])
    slot_sorted = torch.cumsum(new, 0) - 1
    uniq = flat.new_full((cap + 1,), -1)
    uniq[slot_sorted.clamp_max(cap)] = s
    inv = torch.empty_like(slot_sorted)
    inv[order] = slot_sorted
    return uniq[:cap], inv, slot_sorted[-1] + 1


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor, mesh: Mesh,
                   dedup_cap: int = 0, with_overflow: bool = False,
                   width: int = 0, group: int = 1):
    """ids [B, ...] int32 → float32 embeddings [B, ..., D]; negative ids
    (padding) give zero rows. width > 0: the table's rows are packed
    [V, 128] lines and the first `width` lanes are the embedding. group >
    1: the table is grouped lines of `group` rows (width must be the
    emb dim), ids stay row ids. On a mesh above 1×1, `table` is this
    rank's model shard and `ids` its data shard's ids (module
    docstring). with_overflow=True returns (out, overflow): the unique
    ids past dedup_cap, summed over the data shards (0 on one device,
    which is exact). Differentiable with respect to a plain table."""
    if group > 1 and not width:
        raise ValueError("grouped lookup requires width=emb_dim")
    if mesh.size > 1:
        return _sharded_lookup(table, ids, mesh, dedup_cap, with_overflow,
                               width, group)
    safe = ids.clamp_min(0)
    if group == 1 and not width:
        emb = TableRows.apply(table, safe)
    else:
        emb = gather_rows(table, safe, group=group, dim=width)
    out = torch.where(ids[..., None] < 0, 0.0, emb)
    if with_overflow:
        return out, torch.zeros((), dtype=torch.int32, device=ids.device)
    return out


def _sharded_lookup(table, ids, mesh, dedup_cap, with_overflow, width,
                    group):
    """The shard_map branch of JAX's sharded_lookup (:170-199)."""
    out_dim = width or table.shape[1]
    if not dedup_cap:
        out = _local_gather(table, ids.clamp_min(0), mesh, width, group)
        out = torch.where(ids[..., None] < 0, 0.0, out)
        over = torch.zeros((), dtype=torch.int32, device=ids.device)
    else:
        flat = ids.reshape(-1)
        cap = min(dedup_cap, flat.shape[0])
        uniq, inv, n_unique = _dedup_flat(flat, cap)
        emb_u = _local_gather(table, uniq.clamp_min(0), mesh, width, group)
        emb_u = torch.where(uniq[:, None] < 0, 0.0, emb_u)
        out = emb_u[inv.clamp(0, cap - 1)].reshape(*ids.shape, out_dim)
        # the ids are the same on every model shard: summing over data
        # alone gives the global count of dropped ids
        over = psum((n_unique - cap).clamp_min(0).to(torch.int32), mesh,
                    DATA_AXIS)
    return (out, over) if with_overflow else out


def shard_local_ids(ids: torch.Tensor, shard: int, per: int
                    ) -> torch.Tensor:
    """ids [B, K] (-1 pads) masked to model shard `shard` of `per` rows:
    id - shard·per where that lies in [0, per), else -1; int32,
    contiguous (the ids K3 pools on a mesh above 1×1)."""
    rel = ids - shard * per
    valid = (ids >= 0) & (rel >= 0) & (rel < per)
    return torch.where(valid, rel, -1).to(torch.int32).contiguous()


def sharded_pooled_lookup(table: torch.Tensor, ids: torch.Tensor,
                          mesh: Mesh, combiner: str = "mean"
                          ) -> torch.Tensor:
    """Gather + pool of a plain [V, D] table: ids [B, K] (-1 pads) →
    pooled [B, D] float32, differentiable with respect to the table. On
    one device "mean" is kernel K3 (GatherPoolMean), "sum" a
    differentiable gather and a sum, as in JAX; on a larger mesh K3 sums
    this shard's rows, the sums are psummed over `model` and "mean"
    divides by the count of valid ids."""
    if mesh.size > 1:
        local = shard_local_ids(ids, mesh.index(MODEL_AXIS), table.shape[0])
        pooled = psum(GatherPoolSum.apply(table, local), mesh, MODEL_AXIS)
        if combiner == "mean":
            count = (ids >= 0).to(torch.float32).sum(1, keepdim=True)
            pooled = pooled / count.clamp_min(1.0)
        return pooled
    if combiner == "mean":
        return gather_pool_mean(table, ids)
    valid = (ids >= 0).to(table.dtype)
    emb = TableRows.apply(table, ids.clamp_min(0))
    return (emb * valid[..., None]).sum(1)
