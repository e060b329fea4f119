"""Shared model contract and pieces (port of goctr_tpu/models/base.py).

The reference feeds every ranker the same flat float32 row, partitioned by
`SampleInfo` column ranges into user-profile / user-behavior / item /
context blocks (recommend/rcmd.go:132-137). The dense trainer keeps that
layout: one [N, W] tensor on the device, and `split_blocks` cuts a batch
into views of it.

Models follow the JAX package's pure contract: `init_params(generator)`
returns a dict of float32 tensors (nested lists under "mlp" and "bias")
on the generator's device, and `apply(params, blocks, train=,
generator=)` returns float32 logits [B]. The parameter leaves, in the
order `param_leaves` lists them, are the order of `jax.tree.leaves` of
the JAX params dict, which the solvers' state follows
(optim/optimizers.py).

Fresh initialisation draws from an explicit `torch.Generator`; its numbers
differ from JAX's threefry streams for the same seed, so parity tests copy
parameters across (convert.py) instead of re-drawing them. `dropout`
draws its keep mask from a `torch.Generator` too, so its stream cannot
match JAX's either: parity tests run with rate 0.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SampleInfo:
    """Column ranges [start, end) into the flat feature row."""
    user_profile_range: tuple[int, int]
    user_behavior_range: tuple[int, int]
    item_feature_range: tuple[int, int]
    ctx_feature_range: tuple[int, int]

    @property
    def width(self) -> int:
        return max(r[1] for r in (self.user_profile_range,
                                  self.user_behavior_range,
                                  self.item_feature_range,
                                  self.ctx_feature_range))

    def dims(self, behavior_len: int) -> tuple[int, int, int, int, int]:
        """(u_profile_dim, behavior_len, behavior_dim, item_dim, ctx_dim)."""
        up = self.user_profile_range[1] - self.user_profile_range[0]
        ub = self.user_behavior_range[1] - self.user_behavior_range[0]
        it = self.item_feature_range[1] - self.item_feature_range[0]
        cx = self.ctx_feature_range[1] - self.ctx_feature_range[0]
        if behavior_len > 0 and ub % behavior_len != 0:
            raise ValueError(
                f"behavior block {ub} not divisible by T={behavior_len}")
        bd = ub // behavior_len if behavior_len else 0
        return up, behavior_len, bd, it, cx


@dataclasses.dataclass
class TrainSample:
    """Assembled training set (reference TrainSample rcmd.go:60-67)."""
    x: np.ndarray          # [N, W] float32
    y: np.ndarray          # [N] float32 in {0,1}
    info: SampleInfo

    @property
    def rows(self) -> int:
        return self.x.shape[0]

    @property
    def x_cols(self) -> int:
        return self.x.shape[1]


def split_blocks(x: torch.Tensor, info: SampleInfo, behavior_len: int):
    """Flat [B, W] rows → (user_profile, behaviors [B, T, D], item, ctx),
    views of x (strided, not contiguous)."""
    up = x[:, info.user_profile_range[0]:info.user_profile_range[1]]
    ubm = x[:, info.user_behavior_range[0]:info.user_behavior_range[1]]
    it = x[:, info.item_feature_range[0]:info.item_feature_range[1]]
    cx = x[:, info.ctx_feature_range[0]:info.ctx_feature_range[1]]
    if behavior_len:
        ub = ubm.unflatten(1, (behavior_len, -1))
    else:
        ub = ubm[:, :0].reshape(ubm.shape[0], 0, 0)
    return up, ub, it, cx


@runtime_checkable
class RankModel(Protocol):
    behavior_len: int

    def init_params(self, generator: torch.Generator) -> dict: ...

    def apply(self, params: dict, blocks: tuple, *, train: bool = False,
              generator: Optional[torch.Generator] = None
              ) -> torch.Tensor: ...


def param_leaves(params: dict) -> list[torch.Tensor]:
    """The tensors of a params dict in `jax.tree.leaves` order: keys
    sorted, list entries in order."""
    out: list[torch.Tensor] = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            out += param_leaves(v)
        elif isinstance(v, (list, tuple)):
            out += list(v)
        else:
            out.append(v)
    return out


# ------------------------------------------------------------ shared pieces --

def glorot(generator: torch.Generator, shape: tuple[int, int],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Uniform(-b, b), b = sqrt(6 / (fan_in + fan_out)), on the
    generator's device."""
    fan_in, fan_out = shape[0], shape[1]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return u.mul_(2.0 * bound).sub_(bound)


def init_linear(generator: torch.Generator, shape: tuple[int, int],
                init: str) -> torch.Tensor:
    """A weight matrix: "reference" draws N(0, 1), the reference's init
    (din.go:188-194, kept for ablation parity only); anything else glorot."""
    if init == "reference":
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=generator.device)
    return glorot(generator, shape)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None, train: bool) -> torch.Tensor:
    """Inverted dropout (goctr_tpu/models/base.py `dropout`): keep each
    entry with probability 1 - rate and scale it by 1 / (1 - rate).
    Identity unless training with rate > 0 and a generator."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                   device=x.device)
    return torch.where(u < keep, x / keep, 0.0)
