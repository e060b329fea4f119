"""The (data, model) device mesh (port of goctr_tpu/core/meshes.py:21-66).

The JAX package routes all parallelism through a `jax.sharding.Mesh` with
a `data` axis (batch) and a `model` axis (row-sharded embedding tables).
The port runs that design on one card so far: a `Mesh` here is the axis
sizes and the torch device, and only the 1×1 mesh exists. A spec that
resolves to more than one device raises NotImplementedError (ROADMAP
A5b: torch.distributed meshes, NCCL on the card, gloo on the CPU); no
spec falls back to one device quietly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from goctr_tpu_torch.core.dtypes import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """How to slice the device set into (data, model) axes."""

    data: int = -1  # -1: all remaining devices
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = max(1, self.model)
        if n_devices % model != 0:
            raise ValueError(f"{n_devices} devices not divisible by "
                             f"model={model}")
        data = self.data if self.data > 0 else n_devices // model
        if data * model != n_devices:
            raise ValueError(f"mesh {data}x{model} != {n_devices} devices")
        return data, model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) mesh over `device`; only 1×1 so far."""

    data: int
    model: int
    device: torch.device

    def __post_init__(self):
        if self.data * self.model != 1:
            raise NotImplementedError(
                f"a {self.data}x{self.model} mesh needs torch.distributed "
                "across cards, which the port does not have yet (ROADMAP "
                "A5b); use a 1x1 mesh")

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name, as `jax.sharding.Mesh.shape` gives them."""
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence[str | torch.device]] = None
              ) -> Mesh:
    """A mesh over the given devices, or over every CUDA card."""
    spec = spec or MeshSpec()
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    d, m = spec.resolve(len(devices))
    return Mesh(d, m, resolve_device(devices[0]))   # raises above 1x1


def single_device_mesh(device: str | torch.device = "cuda") -> Mesh:
    return make_mesh(MeshSpec(data=1, model=1), devices=[device])
