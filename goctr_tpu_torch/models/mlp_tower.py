"""Plain MLP ranker over the whole flat feature row (port of
goctr_tpu/models/mlp_tower.py).

The counterpart of the reference's SimpleMlp wrapper path
(model/mlp/mlp.go:45-65 → sklearn-port MLPClassifier with hidden [100],
relu — main.go:42-47): ignores the 4-block structure and consumes the
full row. Logits out; glorot + bias by default. `tower` is the dense
stack all three rankers share: compute-dtype operands, float32 products
(`matmul_f32`), bias and activation in float32, dropout after each hidden
activation, a cast back to the compute dtype between layers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from goctr_tpu_torch.models.base import dropout, init_linear
from goctr_tpu_torch.ops.activations import ACTIVATIONS
from goctr_tpu_torch.ops.matmul import matmul_f32


def init_tower(generator: torch.Generator, dims: tuple[int, ...],
               parity_init: bool, use_bias: bool) -> dict:
    """{"mlp": [W_i], "bias": [b_i] (when use_bias)} for layer widths
    `dims`, weights drawn in order from `generator`, biases zero."""
    init = "reference" if parity_init else "glorot"
    params = {"mlp": [init_linear(generator, (dims[i], dims[i + 1]), init)
                      for i in range(len(dims) - 1)]}
    if use_bias:
        params["bias"] = [torch.zeros(d, device=generator.device)
                          for d in dims[1:]]
    return params


def tower(params: dict, h: torch.Tensor, cd: torch.dtype, activation: str,
          rates: tuple[float, ...], train: bool,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """Float32 logits [B] of the MLP over h [B, in] (already in `cd`);
    hidden layer i drops with rates[min(i, len(rates) - 1)]."""
    act = ACTIVATIONS[activation]
    biases = params.get("bias")
    n_layers = len(params["mlp"])
    for i, w in enumerate(params["mlp"]):
        h = matmul_f32(h, w.to(cd))
        if biases is not None:
            h = h + biases[i]
        if i < n_layers - 1:
            h = act(h)
            h = dropout(h, rates[min(i, len(rates) - 1)], generator, train)
            h = h.to(cd)
    return h[:, 0].float()


@dataclasses.dataclass
class MLPTower:
    in_dim: int
    hidden: tuple[int, ...] = (100,)
    activation: str = "relu"
    dropout_rate: float = 0.0
    use_bias: bool = True
    parity_init: bool = False
    compute_dtype: torch.dtype = torch.float32
    behavior_len: int = 0   # unused; keeps the RankModel contract uniform

    def init_params(self, generator: torch.Generator) -> dict:
        dims = (self.in_dim,) + tuple(self.hidden) + (1,)
        return init_tower(generator, dims, self.parity_init, self.use_bias)

    def apply(self, params: dict, blocks: tuple, *, train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # the full row: blocks=(x,), or the 4-block tuple re-concatenated
        if len(blocks) == 1:
            h = blocks[0]
        else:
            profile, behaviors, item, ctx = blocks
            h = torch.cat([profile, behaviors.flatten(1), item, ctx], dim=1)
        cd = self.compute_dtype
        return tower(params, h.to(cd), cd, self.activation,
                     (self.dropout_rate,), train, generator)
