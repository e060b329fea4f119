"""SparseCTR — item-id embeddings, DIN attention pool, dense tower
(port of goctr_tpu/parallel/sparse_ctr.py:28-188 on the 1×1 mesh).

The module owns the dense parameters under the JAX package's names
(`att0`, `mlp.<i>`, `bias.<i>` in `state_dict()`, float32); the item
table lives beside it (TrainedScanned, TrainedSparseRanker,
DeviceScorer), because the serving and training paths manage it in their
own layouts. `apply(table, batch, mesh)` looks the batch's ids up in it
(parallel/embedding.py) and routes as JAX's `apply` does: mean pooling on
a plain table goes through kernel K3 (the fused gather + pool, rows
pooled in float32, the result cast to the compute dtype); every other
case gathers the rows (K1) and calls `apply_pooled`, which casts the
rows to the compute dtype first and pools there. The mesh trainer's
dense path and plain-table predict take the first; its sparse path, and
predict on packed or grouped tables, the second.

Numerics follow the JAX dtype policy: activations in `compute_dtype`,
every tower matmul takes compute-dtype operands and returns float32
(`preferred_element_type=float32`, :149), bias add and activation in
float32, cast back to the compute dtype between layers, float32 logits.
The DIN pool runs through kernel K2 (ops/kernels/din_attention.py),
which computes in float32 and rounds only its output, where the JAX
inline pool rounds each bf16 intermediate: at bf16 the two agree to
bf16 precision, not bit for bit. Its gradient is kernel K2b, through
the autograd Function DinAttentionPool.

Training mode (`train=True` with a `generator`) applies inverted dropout
after each hidden activation, as the JAX tower does; the keep mask comes
from the generator, so it cannot match JAX's stream. A bf16 product has
no PyTorch derivative, so `matmul_f32` goes through an autograd Function
with the backward JAX computes for `dot(x_bf16, w_bf16,
preferred_element_type=f32)` (read from its jaxpr): dx = bf16(g · wᵀ),
dw = bf16(xᵀ · g), both products in float32 from the float32 cotangent
g. The weight's `.to(bf16)` then widens dw back to float32, as JAX's
`astype(cd)` does. These are plain matmuls, left to cuBLAS on the card
(with TF32 off) as JAX leaves them to XLA.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from goctr_tpu_torch.core.dtypes import resolve_device
from goctr_tpu_torch.core.meshes import Mesh
from goctr_tpu_torch.models.base import dropout, glorot
from goctr_tpu_torch.ops.activations import ACTIVATIONS
from goctr_tpu_torch.ops.kernels.din_attention import DinAttentionPool
from goctr_tpu_torch.ops.kernels.row_optimizer import (
    init_packed_table_grouped,
)
from goctr_tpu_torch.parallel.embedding import (
    EmbeddingSpec, init_table, sharded_lookup, sharded_pooled_lookup,
)

POOLINGS = ("din_attention", "mean")


@dataclasses.dataclass
class SparseBatch:
    """One device batch of raw features."""
    user_profile: torch.Tensor    # [B, U] float32 dense
    behavior_ids: torch.Tensor    # [B, T] int32, -1 padded
    item_ids: torch.Tensor        # [B] int32
    ctx: torch.Tensor             # [B, C] float32 dense
    labels: torch.Tensor          # [B] float32


class _MatmulF32(torch.autograd.Function):
    """bf16 × bf16 → f32 product with JAX's backward (module docstring).
    On the card `torch.mm(..., out_dtype=float32)` (f32 accumulation, no
    bf16 rounding of the result). The CPU has no such overload; there the
    operands are widened first, which gives the same product, since a
    product of two bf16 values is exact in float32."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        if h.is_cuda:
            return torch.mm(h, w, out_dtype=torch.float32)
        return h.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = (g @ w.float().t()).to(h.dtype)
        if ctx.needs_input_grad[1]:
            dw = (h.float().t() @ g).to(w.dtype)
        return dh, dw


def matmul_f32(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h @ w with a float32 result from compute-dtype operands."""
    if h.dtype == torch.float32:
        return h @ w
    return _MatmulF32.apply(h, w)


class SparseCTR(nn.Module):

    def __init__(self, item_vocab: int, emb_dim: int = 16,
                 u_profile_dim: int = 8, ctx_dim: int = 4,
                 behavior_len: int = 10,
                 hidden: tuple[int, ...] = (200, 80),
                 activation: str = "relu", dropout_rate: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32,
                 lookup_dedup_cap: int = 0,
                 pooling: str = "din_attention",
                 device: str | torch.device = "cuda"):
        """Parameters start as att0 = 1, weights and biases 0: draw them
        with `init_params` or load them with `load_state_dict`."""
        super().__init__()
        if pooling not in POOLINGS:
            raise ValueError(f"unknown pooling {pooling!r}")
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.item_vocab = item_vocab
        self.emb_dim = emb_dim
        self.u_profile_dim = u_profile_dim
        self.ctx_dim = ctx_dim
        self.behavior_len = behavior_len
        self.hidden = tuple(hidden)
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        self.lookup_dedup_cap = lookup_dedup_cap
        self.pooling = pooling
        dev = resolve_device(device)
        dims = self.layer_dims
        self.att0 = nn.Parameter(torch.ones(behavior_len, device=dev))
        self.mlp = nn.ParameterList(
            nn.Parameter(torch.zeros(dims[i], dims[i + 1], device=dev))
            for i in range(len(dims) - 1))
        self.bias = nn.ParameterList(
            nn.Parameter(torch.zeros(d, device=dev)) for d in dims[1:])

    @property
    def spec(self) -> EmbeddingSpec:
        return EmbeddingSpec("item", self.item_vocab, self.emb_dim)

    @property
    def concat_dim(self) -> int:
        # profile + attention-pooled behaviors + item emb + ctx
        return self.u_profile_dim + 2 * self.emb_dim + self.ctx_dim

    @property
    def layer_dims(self) -> tuple[int, ...]:
        return (self.concat_dim,) + self.hidden + (1,)

    def config(self) -> dict:
        """The model_config of a scanned checkpoint (same keys as the JAX
        package writes)."""
        return {"item_vocab": self.item_vocab, "emb_dim": self.emb_dim,
                "u_profile_dim": self.u_profile_dim,
                "ctx_dim": self.ctx_dim, "behavior_len": self.behavior_len,
                "hidden": list(self.hidden), "activation": self.activation,
                "dropout_rate": self.dropout_rate,
                "lookup_dedup_cap": self.lookup_dedup_cap}

    @torch.no_grad()
    def init_params(self, generator: torch.Generator,
                    table_group: int = 1) -> torch.Tensor:
        """Draw fresh dense parameters (glorot weights, zero biases,
        att0 = 1) from `generator` and return a fresh item table on the
        generator's device: [V, D] N(0, 0.01²), or with table_group > 1
        grouped lines [ceil(V/G), 128] drawn straight into line layout."""
        dims = self.layer_dims
        for i, w in enumerate(self.mlp):
            w.copy_(glorot(generator, (dims[i], dims[i + 1])))
        for b in self.bias:
            b.zero_()
        self.att0.fill_(1.0)
        if table_group > 1:
            return init_packed_table_grouped(generator, self.item_vocab,
                                             self.emb_dim)
        return init_table(generator, self.spec)

    def param_leaves(self) -> list[nn.Parameter]:
        """The dense parameters in JAX leaf order (att0, bias.*, mlp.*):
        the order of `jax.tree.leaves` of the JAX dense-params dict, which
        the solvers' state follows (optim/optimizers.py)."""
        return [self.att0, *self.bias, *self.mlp]

    def apply_pooled(self, profile: torch.Tensor, behaviors: torch.Tensor,
                     item: torch.Tensor, ctx: torch.Tensor,
                     mask: torch.Tensor, *, train: bool = False,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
        """Logits [B] over pre-gathered embeddings: behaviors [B, T, D],
        item [B, D], mask [B, T] float32 (1 for real behaviors, 0 for -1
        pads), profile [B, U], ctx [B, C]. Differentiable with respect to
        the dense parameters and the gathered rows."""
        cd = self.compute_dtype
        behaviors = behaviors.to(cd)
        item = item.to(cd)
        if self.pooling == "mean":
            # YouTube-DNN watch-history average (dnn.go:182-203)
            m = mask.to(cd)
            denom = torch.clamp(m.sum(1, keepdim=True), min=1.0)
            pooled = (behaviors * m[..., None]).sum(1) / denom
        else:
            # DIN-style gated attention pool (din.go:231-298 semantics)
            pooled = DinAttentionPool.apply(behaviors, item, self.att0,
                                            mask.float())
        return self._tower(profile, pooled, item, ctx, train=train,
                           generator=generator)

    forward = apply_pooled

    def _tower(self, profile, pooled, item, ctx, *, train: bool = False,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """Dense MLP over [profile | pooled behaviors | item | ctx]."""
        cd = self.compute_dtype
        h = torch.cat([profile.to(cd), pooled.to(cd), item.to(cd),
                       ctx.to(cd)], dim=1)
        act = ACTIVATIONS[self.activation]
        n_layers = len(self.mlp)
        for i, (w, b) in enumerate(zip(self.mlp, self.bias)):
            h = matmul_f32(h, w.to(cd)) + b
            if i < n_layers - 1:
                h = dropout(act(h), self.dropout_rate, generator,
                            train).to(cd)
        return h[:, 0].float()   # logits

    def apply(self, table: torch.Tensor, batch: SparseBatch, mesh: Mesh, *,
              train: bool = False, generator: torch.Generator | None = None,
              table_group: int = 1, table_packed: bool = False
              ) -> torch.Tensor:
        """Logits [B] of `batch` with the item rows looked up in `table`:
        a plain [V, D] table, or with table_group > 1 grouped lines, or
        with table_packed one-row-per-line [V, 128] (w | acc | pad) rows
        (the lookups take the first emb_dim lanes). Differentiable with
        respect to the dense parameters and a plain table. (The JAX
        package's name; it shadows nn.Module.apply, which nothing here
        calls.)"""
        g = table_group
        w = self.emb_dim if (g > 1 or table_packed) else 0
        item = sharded_lookup(table, batch.item_ids, mesh,
                              dedup_cap=self.lookup_dedup_cap, width=w,
                              group=g)
        if self.pooling == "mean" and g == 1 and not table_packed:
            # kernel K3: the [B, T, D] behavior rows are never written
            pooled = sharded_pooled_lookup(table, batch.behavior_ids, mesh,
                                           combiner="mean")
            return self._tower(batch.user_profile, pooled, item, batch.ctx,
                               train=train, generator=generator)
        behaviors = sharded_lookup(table, batch.behavior_ids, mesh,
                                   dedup_cap=self.lookup_dedup_cap, width=w,
                                   group=g)
        mask = (batch.behavior_ids >= 0).float()
        return self.apply_pooled(batch.user_profile, behaviors, item,
                                 batch.ctx, mask, train=train,
                                 generator=generator)
