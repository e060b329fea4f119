"""Model persistence (port of goctr_tpu/models/io.py: the reference-JSON
tier :32-100, dense checkpoints :105-172, sparse checkpoints :177-284,
(de)flattening :293-325).

Key names are the JAX package's: nested dicts join with ".", list entries
take their index (`mlp.0`, `bias.0`, `att0`), so an npz written by either
package loads in the other.

1. **Reference-compatible JSON**: the exact field schema of the
   reference's DIN (din.go:41-52) / YouTube-DNN (dnn.go:38-47) marshals,
   row-major flat float lists; the models it gives have no biases (the
   reference has none).
2. **Dense checkpoints** (`save_checkpoint` / `load_checkpoint`): a
   directory of `meta.json` (model type and config, SampleInfo,
   behavior_len, loss curve, trainer_config), `params.npz` and, when
   present, `opt_state.npz` (solver state leaves "0", "1", ... in
   `jax.tree.leaves` order), as the JAX package writes them. The model
   config leaves out `compute_dtype`, as JAX's does (:287-290), so a
   bf16 model loads as float32 (ROADMAP C).
3. **Sparse checkpoints** (the mesh trainer's, TrainedSparseRanker.save):
   a directory of `meta.json` (model_config with `pooling`, loss curve,
   trainer_config, table_opt), `dense.npz`, `table.npz` (the plain [vocab,
   D] table and [vocab] adagrad acc, whatever the layout in memory) and
   `opt_state.npz`, written the same way by both packages. The port's
   SparseCTR keeps its dense parameters under the JAX names in its
   `state_dict()`. The JAX loader builds its solver state template from
   the dense parameters alone, so it cannot load the state of a
   dense-path run, which holds the table's leaves too (ROADMAP C); the
   port's loader takes either, told apart by what the file holds.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from goctr_tpu_torch.core.dtypes import resolve_device
from goctr_tpu_torch.models.base import SampleInfo, param_leaves
from goctr_tpu_torch.models.din import DIN
from goctr_tpu_torch.models.mlp_tower import MLPTower
from goctr_tpu_torch.models.trainer import (
    TrainedRanker, TrainerConfig, _params_on, make_trainer_solver,
)
from goctr_tpu_torch.models.youtube_dnn import YoutubeDNN


def _flatten_params(params: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_params(v, key + "."))
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                out[f"{key}.{i}"] = _to_numpy(x)
        else:
            out[key] = _to_numpy(v)
    return out


def _unflatten_params(flat: dict[str, np.ndarray]) -> dict:
    """Flat keys → nested dicts and lists of float32 CPU tensors."""
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(v))
    return _listify(tree)


def _listify(node):
    if isinstance(node, dict):
        if node and all(k.isdigit() for k in node):
            return [_listify(node[str(i)]) for i in range(len(node))]
        return {k: _listify(v) for k, v in node.items()}
    return node


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ----------------------------------------------------- reference JSON tier ---

def _ref_json(model, params: dict, with_att0: bool) -> str:
    d = {"uProfileDim": model.u_profile_dim,
         "uBehaviorSize": model.behavior_len,
         "uBehaviorDim": model.behavior_dim,
         "iFeatureDim": model.i_feature_dim,
         "cFeatureDim": model.c_feature_dim}
    for i in range(3):
        d[f"mlp{i}"] = _to_numpy(params["mlp"][i]).ravel().tolist()
    if with_att0:
        d["att0"] = _to_numpy(params["att0"]).ravel().tolist()
    return json.dumps(d)


def _ref_model(cls, data: str, device):
    """(model without biases, its "mlp" weights) from a reference JSON."""
    m = json.loads(data)
    model = cls(u_profile_dim=m["uProfileDim"],
                behavior_len=m["uBehaviorSize"],
                behavior_dim=m["uBehaviorDim"],
                i_feature_dim=m["iFeatureDim"],
                c_feature_dim=m["cFeatureDim"], use_bias=False)
    dims = (model.concat_dim,) + tuple(model.hidden) + (1,)
    dev = resolve_device(device)
    mlp = [torch.tensor(m[f"mlp{i}"], dtype=torch.float32, device=dev)
           .reshape(dims[i], dims[i + 1]) for i in range(3)]
    return model, m, mlp


def din_to_json(model: DIN, params: dict) -> str:
    return _ref_json(model, params, with_att0=True)


def din_from_json(data: str, device: str | torch.device = "cuda"
                  ) -> tuple[DIN, dict]:
    model, m, mlp = _ref_model(DIN, data, device)
    att0 = torch.tensor(m["att0"], dtype=torch.float32,
                        device=mlp[0].device).reshape(m["uBehaviorSize"])
    return model, {"att0": att0, "mlp": mlp}


def youtube_dnn_to_json(model: YoutubeDNN, params: dict) -> str:
    return _ref_json(model, params, with_att0=False)


def youtube_dnn_from_json(data: str, device: str | torch.device = "cuda"
                          ) -> tuple[YoutubeDNN, dict]:
    model, _, mlp = _ref_model(YoutubeDNN, data, device)
    return model, {"mlp": mlp}


# ------------------------------------------------------- dense checkpoints ---

MODEL_TYPES = {"DIN": DIN, "YoutubeDNN": YoutubeDNN, "MLPTower": MLPTower}


def _model_config_dict(model) -> dict:
    d = dataclasses.asdict(model)
    d.pop("compute_dtype", None)
    return d


def save_checkpoint(path, ranker: TrainedRanker,
                    trainer_config: TrainerConfig | None = None) -> None:
    """Full checkpoint: model config, SampleInfo, params, loss curve, and
    (when present) optimizer state + trainer config, for true
    mid-training resume (reference snapshots are weights-only,
    din.go:62-147)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    meta = {
        "model_type": type(ranker.model).__name__,
        "model_config": _model_config_dict(ranker.model),
        "sample_info": dataclasses.asdict(ranker.info),
        "behavior_len": ranker.behavior_len,
        "loss_curve": [float(x) for x in ranker.loss_curve],
        "trainer_config": (dataclasses.asdict(trainer_config)
                           if trainer_config is not None else None),
    }
    (path / "meta.json").write_text(json.dumps(meta))
    np.savez(path / "params.npz", **_flatten_params(ranker.params))
    if ranker.opt_state is not None:
        np.savez(path / "opt_state.npz",
                 **{str(i): _to_numpy(x)
                    for i, x in enumerate(ranker.opt_state)})


def load_checkpoint(path, device: str | torch.device = "cuda"
                    ) -> TrainedRanker:
    """A dense checkpoint written by either package, on `device`. The
    solver state is loaded when opt_state.npz and a trainer_config exist
    (as the JAX loader does) and must have the leaves of that solver."""
    dev = resolve_device(device)
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    cfg = dict(meta["model_config"])
    for k in ("hidden", "dropout_rates"):
        if isinstance(cfg.get(k), list):
            cfg[k] = tuple(cfg[k])
    model = MODEL_TYPES[meta["model_type"]](**cfg)
    with np.load(path / "params.npz") as z:
        params = _params_on(_unflatten_params(dict(z.items())), dev)
    info = SampleInfo(**{k: tuple(v)
                         for k, v in meta["sample_info"].items()})
    opt_state = None
    opt_path = path / "opt_state.npz"
    tc = meta.get("trainer_config")
    if opt_path.exists() and tc is not None:
        template = make_trainer_solver(TrainerConfig(**tc)).init(
            param_leaves(params))
        with np.load(opt_path) as z:
            opt_state = [torch.from_numpy(np.array(z[str(i)])).to(dev)
                         for i in range(len(z.files))]
        if [tuple(x.shape) for x in opt_state] != [
                tuple(x.shape) for x in template]:
            raise ValueError(f"{opt_path} does not hold the state of the "
                             f"{tc['solver']} solver of these parameters")
    return TrainedRanker(model=model, params=params, info=info,
                         behavior_len=meta["behavior_len"],
                         loss_curve=list(meta["loss_curve"]),
                         opt_state=opt_state)


# ------------------------------------------------------ sparse checkpoints ---

def save_sparse_checkpoint(path, model, dense_params: dict,
                           table_w: np.ndarray, table_acc: np.ndarray,
                           loss_curve: list, opt_state=None,
                           trainer_config=None, table_opt=None) -> None:
    """Write a sparse checkpoint: `model` a SparseCTR, `dense_params` its
    state_dict (or the JAX names' nested dict), the host-exported table
    and acc, `opt_state` the solver state's leaves, `trainer_config` and
    `table_opt` dataclasses (or None)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    meta = {"model_config": dict(model.config(), pooling=model.pooling),
            "loss_curve": [float(x) for x in loss_curve],
            "trainer_config": (dataclasses.asdict(trainer_config)
                               if trainer_config is not None else None),
            "table_opt": (dataclasses.asdict(table_opt)
                          if table_opt is not None else None)}
    (path / "meta.json").write_text(json.dumps(meta))
    np.savez(path / "dense.npz", **_flatten_params(dense_params))
    np.savez(path / "table.npz", table=np.asarray(table_w, np.float32),
             acc=np.asarray(table_acc, np.float32))
    if opt_state is not None:
        np.savez(path / "opt_state.npz",
                 **{str(i): _to_numpy(x) for i, x in enumerate(opt_state)})


def load_sparse_checkpoint(path, mesh):
    """Load a sparse checkpoint written by either package (on any mesh)
    onto `mesh` as a TrainedSparseRanker with a plain [vocab, D] table and
    its acc — on a mesh with m > 1 model shards, this rank's rows of them
    padded to m shards (and of the dense path's table moments in the
    solver state); pass it to train_sparse(resume_from=...), which lays
    the table out for its update mode. The model
    computes in float32 (the checkpoint does not record the compute
    dtype). The solver state is loaded whenever opt_state.npz exists, and
    with a trainer config it must match the solver's state of either path:
    the dense parameters' (sparse path) or theirs and the table's (dense
    path). A table_opt's JAX-only fields (gather_impl, pallas_interpret)
    are dropped. Returns (ranker, trainer_config | None, table_opt |
    None)."""
    from goctr_tpu_torch.core.meshes import row_sharded
    from goctr_tpu_torch.models.trainer import TrainerConfig
    from goctr_tpu_torch.parallel.scanned import (
        _check_opt_state, make_trainer_solver)
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
    from goctr_tpu_torch.parallel.sparse_trainer import TrainedSparseRanker
    from goctr_tpu_torch.parallel.table_opt import TableOptConfig
    from goctr_tpu_torch.parallel.train import (
        dense_path_leaves, table_state_slots)

    dev = mesh.device
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    mc = dict(meta["model_config"])
    mc["hidden"] = tuple(mc["hidden"])
    model = SparseCTR(**mc, device=dev)
    with np.load(path / "dense.npz") as z:
        model.load_state_dict({k: torch.from_numpy(z[k]) for k in z.files})
    with np.load(path / "table.npz") as z:
        w = torch.from_numpy(z["table"].astype(np.float32))
        a = torch.from_numpy(z["acc"].astype(np.float32))
    rows = row_sharded(mesh)
    table = rows.local(w, 1).to(dev)
    acc = rows.local(a, 1).to(dev) if a.numel() else None
    tc = meta.get("trainer_config")
    trainer_config = TrainerConfig(**tc) if tc is not None else None
    to = meta.get("table_opt")
    table_opt = None
    if to is not None:
        names = {f.name for f in dataclasses.fields(TableOptConfig)}
        table_opt = TableOptConfig(**{k: x for k, x in to.items()
                                      if k in names})
    opt_state = None
    opt_path = path / "opt_state.npz"
    if opt_path.exists():
        with np.load(opt_path) as z:
            opt_state = [torch.from_numpy(np.array(z[str(i)]))
                         for i in range(len(z.files))]
        slots = set(table_state_slots(model, opt_state))
        opt_state = [(rows.local(x, 1) if i in slots else x).to(dev)
                     for i, x in enumerate(opt_state)]
        if trainer_config is not None:
            solver = make_trainer_solver(trainer_config)
            templates = [solver.init([p.detach().to("meta") for p in leaves])
                         for leaves in (model.param_leaves(),
                                        dense_path_leaves(model, table))]
            template = next((t for t in templates
                             if len(t) == len(opt_state)), templates[0])
            _check_opt_state(opt_state, template)
    ranker = TrainedSparseRanker(model=model, table=table, mesh=mesh,
                                 loss_curve=meta["loss_curve"],
                                 opt_state=opt_state, acc=acc)
    return ranker, trainer_config, table_opt
