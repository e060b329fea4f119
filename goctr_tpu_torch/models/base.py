"""Shared model pieces (port of goctr_tpu/models/base.py:92-104).

Fresh initialisation draws from an explicit `torch.Generator`; its numbers
differ from JAX's threefry streams for the same seed, so parity tests copy
parameters across (convert.py) instead of re-drawing them. `dropout`
draws its keep mask from a `torch.Generator` too, so its stream cannot
match JAX's either: parity tests run with rate 0.
"""
from __future__ import annotations

import math

import torch


def glorot(generator: torch.Generator, shape: tuple[int, int],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Uniform(-b, b), b = sqrt(6 / (fan_in + fan_out)), on the
    generator's device."""
    fan_in, fan_out = shape[0], shape[1]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return u.mul_(2.0 * bound).sub_(bound)


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
