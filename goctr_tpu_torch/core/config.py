"""Dataclass config system with dotted CLI overrides (port of
goctr_tpu/core/config.py, field for field).

Replaces the reference's code-level struct-field hyperparameters
(main.go:42-49, example/movielens/dinimpl_test.go:36-43) and its unused
config stub (config/config.go:3-6) with one typed, serializable config
tree: `Config()` → override via `--key=value` / `--section.key=value` →
`to_dict()/from_dict()` for experiment logging. `ParallelConfig` is kept
for the JAX package's field set; the port's entry points read none of it.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Sequence


@dataclasses.dataclass
class DataConfig:
    db_type: str = "sqlite"            # mirrors reference config.Config{DbType, Dsn}
    dsn: str = "movielens.db"
    batch_size: int = 256
    prefetch: int = 4                  # host-side pipeline depth (replaces SampleAssembler=16)
    shuffle: bool = True
    seed: int = 0


@dataclasses.dataclass
class ModelConfig:
    name: str = "mlp"                  # mlp | youtube_dnn | din
    hidden: tuple[int, ...] = (100,)
    activation: str = "relu"
    dropout: float = 0.0
    item_emb_dim: int = 16             # reference ItemEmbDim rcmd.go:22
    user_behavior_len: int = 10        # reference UserBehaviorLen rcmd.go:24
    use_bf16: bool = True


@dataclasses.dataclass
class OptimConfig:
    solver: str = "adam"               # sgd|adam|adagrad|rmsprop|adadelta|lbfgs
    lr: float = 1e-3
    lr_schedule: str = "constant"      # constant|invscaling|adaptive
    power_t: float = 0.5
    alpha: float = 1e-5                # L2 penalty (sklearn-style), main.go:46
    weight_decay: float = 0.0
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    max_iter: int = 20
    early_stop_patience: int = 10
    tol: float = 1e-4
    batch_size: int = 200


@dataclasses.dataclass
class ParallelConfig:
    data: int = -1                     # -1 = all remaining devices
    model: int = 1
    shard_embedding_tables: bool = True


@dataclasses.dataclass
class ServeConfig:
    host: str = "0.0.0.0"
    port: int = 8080
    api_path: str = "/api/v1/recommend"
    predict_batch_size: int = 100


@dataclasses.dataclass
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    seed: int = 42
    verbose: bool = False

    # ------------------------------------------------------------- plumbing --
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        cfg = cls()
        _apply_dict(cfg, d)
        return cfg

    def apply_overrides(self, argv: Sequence[str]) -> list[str]:
        """Apply `--a.b=v` style overrides; returns unconsumed args."""
        rest = []
        for arg in argv:
            if arg.startswith("--") and "=" in arg:
                key, val = arg[2:].split("=", 1)
                try:
                    _set_dotted(self, key, val)
                    continue
                except (AttributeError, KeyError):
                    pass
            rest.append(arg)
        return rest


def _apply_dict(obj: Any, d: dict) -> None:
    for k, v in d.items():
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _apply_dict(cur, v)
        else:
            setattr(obj, k, _coerce(type(cur), cur, v))


def _set_dotted(obj: Any, dotted: str, raw: str) -> None:
    parts = dotted.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    cur = getattr(obj, parts[-1])   # raises AttributeError for unknown keys
    setattr(obj, parts[-1], _coerce(type(cur), cur, raw))


def _coerce(typ: type, cur: Any, raw: Any) -> Any:
    if not isinstance(raw, str):
        return tuple(raw) if isinstance(cur, tuple) else raw
    if typ is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(raw)
    if typ is float:
        return float(raw)
    if typ is tuple or isinstance(cur, tuple):
        items = [x for x in raw.strip("()[] ").split(",") if x.strip()]
        elem = int if all(x.strip().lstrip("-").isdigit() for x in items) else str
        return tuple(elem(x.strip()) for x in items)
    return raw
