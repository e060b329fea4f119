"""Trainer configuration (port of goctr_tpu/models/trainer.py:36-60).

Only `TrainerConfig` so far: the scanned SparseCTR trainer
(parallel/scanned.py) reads it. Fields and defaults are the JAX
package's, so a checkpoint's `trainer_config` (the dataclass as a dict)
is read by either package. `TrainedRanker` and the dense trainer come
with the dense-ranker slice (ROADMAP A6).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TrainerConfig:
    batch_size: int = 200
    epochs: int = 200
    early_stop: int = 20           # 0 disables
    solver: str = "adam"
    lr: float = 1e-3
    lr_schedule: str = "constant"
    power_t: float = 0.5
    l2: float = 1e-4               # classic L2, added before the solver
    weight_decay: float = 0.0
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    shuffle: bool = True
    seed: int = 0
    tol: float = 0.0               # min improvement to reset patience
    verbose: bool = False
    # read by the dense trainer only (as in the JAX package); kept so the
    # field set, and a checkpoint's trainer_config, match
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
    store_dtype: str = "float32"
