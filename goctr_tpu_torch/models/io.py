"""Sparse checkpoints and parameter (de)flattening for npz files (port
of goctr_tpu/models/io.py: save_sparse_checkpoint :177-215,
load_sparse_checkpoint :218-284, :293-325).

Key names are the JAX package's: nested dicts join with ".", list entries
take their index (`mlp.0`, `bias.0`, `att0`), so an npz written by either
package loads in the other. The port's SparseCTR keeps its dense
parameters under the same names in its `state_dict()`.

A sparse checkpoint (the mesh trainer's, TrainedSparseRanker.save) is a
directory of `meta.json` (model_config with `pooling`, loss curve,
trainer_config, table_opt), `dense.npz`, `table.npz` (the plain [vocab,
D] table and [vocab] adagrad acc, whatever the layout in memory) and
`opt_state.npz` (solver state leaves "0", "1", ... in JAX leaf order),
written the same way by both packages. The JAX loader builds its solver
state template from the dense parameters alone, so it cannot load the
state of a dense-path run, which holds the table's leaves too (ROADMAP
C); the port's loader takes either, told apart by what the file holds.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch


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
    """Load a sparse checkpoint written by either package onto `mesh` as a
    TrainedSparseRanker with a plain [vocab, D] table and its acc; pass it to train_sparse(resume_from
    =...), which lays the table out for its update mode. The model
    computes in float32 (the checkpoint does not record the compute
    dtype). The solver state is loaded whenever opt_state.npz exists, and
    with a trainer config it must match the solver's state of either path:
    the dense parameters' (sparse path) or theirs and the table's (dense
    path). A table_opt's JAX-only fields (gather_impl, pallas_interpret)
    are dropped. Returns (ranker, trainer_config | None, table_opt |
    None)."""
    from goctr_tpu_torch.models.trainer import TrainerConfig
    from goctr_tpu_torch.parallel.scanned import (
        _check_opt_state, make_trainer_solver)
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
    from goctr_tpu_torch.parallel.sparse_trainer import TrainedSparseRanker
    from goctr_tpu_torch.parallel.table_opt import TableOptConfig
    from goctr_tpu_torch.parallel.train import dense_path_leaves

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
    table = w.to(dev)           # one model shard: no padding rows
    acc = a.to(dev) if a.numel() else None
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
            opt_state = [torch.from_numpy(np.array(z[str(i)])).to(dev)
                         for i in range(len(z.files))]
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
