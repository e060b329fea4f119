"""Config-driven feed-forward network (port of goctr_tpu/models/neural.py;
the reference's legacy neuron-graph engine: layout, per-layer
activations, bias, loss, weight std-dev init, JSON dump and restore).

Training is plain minibatch SGD on the device: the rows are uploaded
once, each epoch takes a numpy permutation from `np.random.default_rng(
seed)` exactly as the JAX package does, and the per-step losses are
summed on the host in the same order, so with the weights carried across
(`convert.neural_from_jax`) a whole training run compares with JAX's,
shuffling included. Fresh weights come from a torch generator (normal ×
weight_std), which no JAX stream matches.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from goctr_tpu_torch.core.dtypes import resolve_device
from goctr_tpu_torch.ops.activations import ACTIVATIONS


@dataclasses.dataclass
class NeuralConfig:
    """The reference's nn.Config, field for field as in the JAX package."""
    inputs: int
    layout: tuple[int, ...]                     # neurons per layer
    activation: str | tuple[str, ...] = "sigmoid"
    mode: str = "binary"                        # binary|multiclass|regression
    bias: bool = True
    weight_std: float = 0.5                     # normal init std
    loss: str = "cross_entropy"                 # cross_entropy|mse

    def activations(self) -> tuple[str, ...]:
        if isinstance(self.activation, str):
            return (self.activation,) * len(self.layout)
        return tuple(self.activation)


class Neural:

    def __init__(self, config: NeuralConfig, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.config = config
        self.device = device
        gen = torch.Generator().manual_seed(seed)
        dims = (config.inputs,) + tuple(config.layout)
        self.weights: list[np.ndarray] = [
            (torch.randn((dims[i], dims[i + 1]), generator=gen)
             * config.weight_std).numpy() for i in range(len(dims) - 1)]
        self.biases: list[np.ndarray] = [
            np.zeros(d, np.float32) for d in dims[1:]]

    def _fwd(self, params, x: torch.Tensor) -> torch.Tensor:
        acts = self.config.activations()
        h = x
        for i, (w, b) in enumerate(zip(params["w"], params["b"])):
            h = h @ w
            if self.config.bias:
                h = h + b
            h = ACTIVATIONS[acts[i]](h)
        return h

    def _params(self, dev: torch.device):
        return {"w": [torch.from_numpy(w).to(dev) for w in self.weights],
                "b": [torch.from_numpy(b).to(dev) for b in self.biases]}

    # ------------------------------------------------------------ forward --
    def forward(self, x: np.ndarray) -> np.ndarray:
        dev = resolve_device(self.device)
        h = torch.from_numpy(np.atleast_2d(np.asarray(x, np.float32)))
        with torch.no_grad():
            return self._fwd(self._params(dev), h.to(dev)).cpu().numpy()

    predict = forward

    # -------------------------------------------------------------- train --
    def train(self, X, Y, *, lr: float = 0.1, epochs: int = 100,
              batch_size: int = 32, seed: int = 0) -> list[float]:
        dev = resolve_device(self.device)
        X = np.asarray(X, np.float32)
        Y = np.atleast_2d(np.asarray(Y, np.float32))
        if Y.shape[0] != X.shape[0]:
            Y = Y.T
        x = torch.from_numpy(X).to(dev)
        y = torch.from_numpy(np.ascontiguousarray(Y)).to(dev)

        def loss_fn(params, xb, yb):
            out = self._fwd(params, xb)
            if self.config.loss == "mse":
                return torch.mean((out - yb) ** 2)
            eps = 1e-7
            out = torch.clamp(out, eps, 1 - eps)
            return -torch.mean(yb * torch.log(out)
                               + (1 - yb) * torch.log(1 - out))

        params = self._params(dev)
        rng = np.random.default_rng(seed)
        curve = []
        n = X.shape[0]
        for _ in range(epochs):
            perm = torch.from_numpy(rng.permutation(n)).to(dev)
            losses, sizes = [], []
            for s in range(0, n, batch_size):
                idx = perm[s:s + batch_size]
                leaves = {k: [p.requires_grad_(True) for p in v]
                          for k, v in params.items()}
                with torch.enable_grad():
                    loss = loss_fn(leaves, x[idx], y[idx])
                    # bias=False leaves the biases unused: zero grads
                    grads = torch.autograd.grad(
                        loss, leaves["w"] + leaves["b"], allow_unused=True,
                        materialize_grads=True)
                k = len(leaves["w"])
                params = {
                    "w": [(p - lr * g).detach() for p, g in
                          zip(leaves["w"], grads[:k])],
                    "b": [(p - lr * g).detach() for p, g in
                          zip(leaves["b"], grads[k:])]}
                losses.append(loss.detach())
                sizes.append(idx.numel())
            tot = 0.0
            for l, size in zip(torch.stack(losses).cpu().tolist(), sizes):
                tot += l * size
            curve.append(tot / n)
        self.weights = [w.cpu().numpy() for w in params["w"]]
        self.biases = [b.cpu().numpy() for b in params["b"]]
        return curve

    # ------------------------------------------------------------ persist --
    def marshal(self) -> str:
        """The full config and weights as JSON (the reference's persist)."""
        return json.dumps({
            "config": dataclasses.asdict(self.config),
            "weights": [w.tolist() for w in self.weights],
            "biases": [b.tolist() for b in self.biases],
        })

    @classmethod
    def unmarshal(cls, blob: str, device: str | torch.device = "cuda"
                  ) -> "Neural":
        d = json.loads(blob)
        cfg = d["config"]
        cfg["layout"] = tuple(cfg["layout"])
        if isinstance(cfg["activation"], list):
            cfg["activation"] = tuple(cfg["activation"])
        net = cls(NeuralConfig(**cfg), device=device)
        net.weights = [np.asarray(w, np.float32) for w in d["weights"]]
        net.biases = [np.asarray(b, np.float32) for b in d["biases"]]
        return net
