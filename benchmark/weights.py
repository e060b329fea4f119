"""The initial weights of a run, drawn on the device from the seed: the
inputs that the program and the reference both start from.

Dense leaves in the trainer's leaf order (att0, bias.0.., mlp.0..):
att0 = 1, biases 0, each tower weight glorot-uniform [fan_in, fan_out];
the item table [V, D] float32 N(0, 0.01²), drawn in one call.
"""
from __future__ import annotations

import math

import torch

from benchmark.counts import layer_dims

TABLE_SCALE = 0.01


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed) * 4 + 1)
    return gen


def draw_dense(model: dict, t: int, seed: int, device) -> dict:
    """{leaf name: float32 tensor} on `device`."""
    gen = _generator(seed, device)
    dims = layer_dims(model)
    out = {"att0": torch.ones(t, device=device)}
    for i in range(len(dims) - 1):
        out[f"bias.{i}"] = torch.zeros(dims[i + 1], device=device)
    for i in range(len(dims) - 1):
        bound = math.sqrt(6.0 / (dims[i] + dims[i + 1]))
        u = torch.rand((dims[i], dims[i + 1]), generator=gen,
                       device=device)
        out[f"mlp.{i}"] = u.mul_(2.0 * bound).sub_(bound)
    return out


def draw_table(model: dict, t: int, seed: int, device) -> torch.Tensor:
    """The [V, D] float32 table. Drawn after the dense leaves from the same
    generator, so it is the same tensor whenever it is drawn again."""
    gen = _generator(seed, device)
    dims = layer_dims(model)
    for i in range(len(dims) - 1):           # advance past the dense draw
        torch.rand((dims[i], dims[i + 1]), generator=gen, device=device)
    table = torch.randn((model["item_vocab"], model["emb_dim"]),
                        generator=gen, device=device)
    return table.mul_(TABLE_SCALE)
