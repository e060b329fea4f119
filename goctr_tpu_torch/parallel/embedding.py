"""Embedding lookups over the (data, model) mesh (port of
goctr_tpu/parallel/embedding.py: EmbeddingSpec :32-39, init_table :42-49,
the single-device branches of sharded_lookup :156-168 and
sharded_pooled_lookup :210-217).

Only the 1×1 mesh exists in the port (core/meshes.py), so a lookup is a
local gather: the `shard_map` branches, their psum over `model` and the
deduplicated exchange `_dedup_flat` come with ROADMAP A5b. On one device
`lookup_dedup_cap` changes nothing and the overflow count is 0, as in
JAX.

The gathers are kernel K1 (ops/kernels/row_gather.py) on every layout:
plain [V, D] rows, packed [V, 128] rows (the first `width` lanes) and
grouped lines (`group` rows a line; K1 reads the row's lanes where JAX
takes the line and selects the slot, `_extract_group`). On a plain table
the gather is differentiable (`TableRows`: backward adds each row's
gradient at its id into a [V, D] gradient, the transpose of `jnp.take`),
which the mesh trainer's dense path needs. Mean pooling is kernel K3
(`GatherPoolMean`); the sum pool gathers and sums.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from goctr_tpu_torch.core.meshes import MODEL_AXIS, Mesh
from goctr_tpu_torch.ops.kernels.embedding_lookup import (
    gather_pool_mean, table_grad)
from goctr_tpu_torch.ops.kernels.row_gather import gather_rows


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    name: str
    vocab: int
    dim: int

    def padded_vocab(self, n_shards: int) -> int:
        return -(-self.vocab // n_shards) * n_shards


def init_table(generator: torch.Generator, spec: EmbeddingSpec,
               mesh: Optional[Mesh] = None, scale: float = 0.01
               ) -> torch.Tensor:
    """[padded_vocab, dim] float32 N(0, scale²) on the generator's
    device (padded to the mesh's model shards; one without a mesh)."""
    rows = spec.padded_vocab(mesh.shape[MODEL_AXIS] if mesh else 1)
    table = torch.randn((rows, spec.dim), generator=generator,
                        dtype=torch.float32, device=generator.device)
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


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor, mesh: Mesh,
                   dedup_cap: int = 0, with_overflow: bool = False,
                   width: int = 0, group: int = 1):
    """ids [B, ...] int32 → float32 embeddings [B, ..., D]; negative ids
    (padding) give zero rows. width > 0: the table's rows are packed
    [V, 128] lines and the first `width` lanes are the embedding. group >
    1: the table is grouped lines of `group` rows (width must be the
    emb dim), ids stay row ids. with_overflow=True returns (out, 0): the
    one-device lookup is exact. Differentiable with respect to a plain
    table."""
    if group > 1 and not width:
        raise ValueError("grouped lookup requires width=emb_dim")
    safe = ids.clamp_min(0)
    if group == 1 and not width:
        emb = TableRows.apply(table, safe)
    else:
        emb = gather_rows(table, safe, group=group, dim=width)
    out = torch.where(ids[..., None] < 0, 0.0, emb)
    if with_overflow:
        return out, torch.zeros((), dtype=torch.int32, device=ids.device)
    return out


def sharded_pooled_lookup(table: torch.Tensor, ids: torch.Tensor,
                          mesh: Mesh, combiner: str = "mean"
                          ) -> torch.Tensor:
    """Gather + pool of a plain [V, D] table: ids [B, K] (-1 pads) →
    pooled [B, D] float32. "mean" is kernel K3 (GatherPoolMean), "sum"
    a differentiable gather and a sum, as in JAX."""
    if combiner == "mean":
        return gather_pool_mean(table, ids)
    valid = (ids >= 0).to(table.dtype)
    emb = TableRows.apply(table, ids.clamp_min(0))
    return (emb * valid[..., None]).sum(1)
