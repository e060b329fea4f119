"""YouTube-DNN ranker: average-pooled behavior history + MLP (port of
goctr_tpu/models/youtube_dnn.py).

Parity with reference model/youtube/dnn.go:162-184: mean-pool the behavior
embeddings over the sequence axis, concat with profile/item/ctx, 200→80→1
sigmoid MLP with dropout 0.003. Logits out, optional bias/glorot,
bf16-ready, as the JAX model.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from goctr_tpu_torch.models.mlp_tower import init_tower, tower


@dataclasses.dataclass
class YoutubeDNN:
    u_profile_dim: int
    behavior_len: int
    behavior_dim: int
    i_feature_dim: int
    c_feature_dim: int
    hidden: tuple[int, ...] = (200, 80)
    activation: str = "sigmoid"
    dropout_rates: tuple[float, float] = (0.003, 0.003)
    use_bias: bool = True
    parity_init: bool = False
    compute_dtype: torch.dtype = torch.float32

    @property
    def concat_dim(self) -> int:
        return (self.u_profile_dim + self.behavior_dim + self.i_feature_dim
                + self.c_feature_dim)

    def init_params(self, generator: torch.Generator) -> dict:
        dims = (self.concat_dim,) + tuple(self.hidden) + (1,)
        return init_tower(generator, dims, self.parity_init,
                          self.use_bias and not self.parity_init)

    def apply(self, params: dict, blocks: tuple, *, train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        profile, behaviors, item, ctx = blocks
        cd = self.compute_dtype
        pooled = behaviors.to(cd).mean(1)                 # dnn.go:167
        h = torch.cat([profile.to(cd), pooled, item.to(cd), ctx.to(cd)],
                      dim=1)
        return tower(params, h, cd, self.activation, self.dropout_rates,
                     train, generator)
