"""DIN — attention-over-behavior-sequence ranker (port of
goctr_tpu/models/din.py).

Behavioral parity with reference model/din/din.go:219-323:
  weight = (cosine_sim(behaviors, item) + 1) / 2          # din.go:231-237
  gate   = sigmoid(weight * att0)                         # din.go:264-276
  pooled = mean(behaviors * gate, axis=seq)               # din.go:298
  out    = MLP(concat(profile, pooled, item, ctx))        # din.go:301-315
with hidden sizes 200→80→1, sigmoid activations, dropout 0.005; logits
out, optional biases + glorot (`parity_init` restores the reference's
Gaussian(0,1)/no-bias setup).

`attention_impl` picks the pool:
- "xla" (the default): torch ops in the compute dtype, op for op as the
  JAX model's inline pool (each bf16 intermediate rounded as there);
- "pallas": kernel K2 forward and K2b backward (`DinAttentionPool`,
  ops/kernels/din_attention.py) with every behavior counted (mask all
  ones, as the JAX call passes none). The kernels compute in float32 and
  round only the pooled output, so at bf16 the two impls agree to bf16
  precision, not bit for bit; in float32 they compute the same function.
  The JAX package cannot differentiate its Pallas pool
  (`_pallas_call_jvp_rule`, ROADMAP C); this one trains.
The name "pallas" is the JAX package's, kept so that checkpoints and
configs read the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from goctr_tpu_torch.models.mlp_tower import init_tower, tower
from goctr_tpu_torch.ops.activations import cosine_similarity
from goctr_tpu_torch.ops.kernels.din_attention import DinAttentionPool


@dataclasses.dataclass
class DIN:
    u_profile_dim: int
    behavior_len: int          # uBehaviorSize, reference UserBehaviorLen=10
    behavior_dim: int          # uBehaviorDim == iFeatureDim (din.go:177)
    i_feature_dim: int
    c_feature_dim: int
    hidden: tuple[int, ...] = (200, 80)
    activation: str = "sigmoid"
    dropout_rates: tuple[float, float] = (0.005, 0.005)
    use_bias: bool = True
    parity_init: bool = False
    compute_dtype: torch.dtype = torch.float32
    attention_impl: str = "xla"

    def __post_init__(self):
        if self.behavior_dim != self.i_feature_dim:
            raise ValueError(
                f"behavior_dim {self.behavior_dim} != i_feature_dim "
                f"{self.i_feature_dim} (required by DIN attention)")
        if self.attention_impl not in ("xla", "pallas"):
            raise ValueError(
                f"attention_impl must be 'xla' or 'pallas', got "
                f"{self.attention_impl!r}")

    @property
    def concat_dim(self) -> int:
        return (self.u_profile_dim + self.behavior_dim + self.i_feature_dim
                + self.c_feature_dim)

    def init_params(self, generator: torch.Generator) -> dict:
        dims = (self.concat_dim,) + tuple(self.hidden) + (1,)
        params = init_tower(generator, dims, self.parity_init,
                            self.use_bias and not self.parity_init)
        params["att0"] = torch.ones(self.behavior_len,           # din.go:185
                                    device=generator.device)
        return params

    def pool(self, att0: torch.Tensor, behaviors: torch.Tensor,
             item: torch.Tensor) -> torch.Tensor:
        """The gated mean of behaviors [B, T, D] in the compute dtype."""
        cd = self.compute_dtype
        behaviors = behaviors.to(cd)
        if self.attention_impl == "pallas":
            # the kernels take contiguous rows (split_blocks gives views)
            # and an f32 att0: rounded to cd first, as JAX passes it
            mask = torch.ones(behaviors.shape[:2], dtype=torch.float32,
                              device=behaviors.device)
            return DinAttentionPool.apply(
                behaviors.contiguous(), item.to(cd).contiguous(),
                att0.to(cd).float(), mask)
        item3 = item.to(cd)[:, None, :]                   # [B, 1, D]
        weight = (cosine_similarity(behaviors, item3) + 1.0) * 0.5
        gate = torch.sigmoid(weight * att0.to(cd))
        return (behaviors * gate[..., None]).mean(1)

    def apply(self, params: dict, blocks: tuple, *, train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        profile, behaviors, item, ctx = blocks
        cd = self.compute_dtype
        pooled = self.pool(params["att0"], behaviors, item)
        h = torch.cat([profile.to(cd), pooled, item.to(cd), ctx.to(cd)],
                      dim=1)
        return tower(params, h, cd, self.activation, self.dropout_rates,
                     train, generator)
