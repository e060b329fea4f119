"""Learning-rate schedules (port of goctr_tpu/optim/schedules.py:12-20).

sklearn-port names: constant | invscaling | adaptive. `adaptive` is
plateau-driven and host-controlled, so here it resolves to constant, as
in the JAX package. A schedule takes the step count (an int, or an int32
tensor on the device, so that no host sync is needed) and returns the
rate (a float, or a float32 tensor).
"""
from __future__ import annotations

from typing import Callable


def make_schedule(name: str, lr_init: float,
                  power_t: float = 0.5) -> Callable:
    name = name.lower()
    if name in ("constant", "adaptive"):
        return lambda step: lr_init
    if name == "invscaling":
        # sklearn: lr = lr_init / (t+1)^power_t, t = step count
        return lambda step: lr_init / (1.0 + step) ** power_t
    raise ValueError(f"unknown lr schedule {name!r}")
