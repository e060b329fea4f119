"""Programs that drive the mesh path on one rank from global numpy inputs
and return global numpy results, so that a caller can hold a (d, m) run
against the 1×1 run of the same start (or against another
implementation of the same steps).

`run_case(case, mesh)` runs one case on this rank's shards of `mesh`:
the inputs are whole (the global batch, the global table), each rank
takes its part (`row_sharded(mesh).local`, `local_batch`), runs the
port's entry points, and gathers the results over the mesh, so every
rank returns the same global arrays. `rank_cases(devices, work)` builds
each (d, m) mesh of `work` in turn on a rank that `core.meshes.launch`
started and runs its cases in order; on the 1×1 mesh `run_case` needs no
process group.

Cases (dicts, `kind` first):
  mesh         the rank's coordinates and the ranks of its axis groups;
               a spec that does not resolve against the world raises
  lookup       sharded_lookup of a table in any layout (plain, packed
               `width`, grouped `group`), ids of any shape, dedup_cap,
               and its overflow count
  pooled       sharded_pooled_lookup, "sum" or "mean"
  lookup_grad  d/dtable of the weighted sum of a plain lookup (the
               table shard's gradient, psummed over `data`, gathered)
  dense_steps  steps of the dense step from a start (dense parameters,
               plain table, adam on every leaf): loss and state after each
  sparse_steps steps of the sparse step from a start in any update mode
               (the table laid out as train_sparse lays it)
  train        train_sparse from a start (a JAX ranker's state, a
               checkpoint, or seed draws), its predict, and a checkpoint
  resume       train_sparse for k epochs with a checkpoint, loaded and
               continued, against the uninterrupted run
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from goctr_tpu_torch.core.meshes import (
    DATA_AXIS, MODEL_AXIS, Mesh, MeshSpec, all_gather, make_mesh, psum,
    row_sharded,
)


def _t(x, dev) -> torch.Tensor:
    """A tensor copy of x (the steps update their inputs in place)."""
    return torch.from_numpy(np.array(x)).to(dev)


def _np(x: torch.Tensor) -> np.ndarray:
    """A numpy copy (never a view of a tensor a later step updates)."""
    return x.detach().cpu().clone().numpy()


def _batch(arrays: dict, mesh: Mesh):
    from goctr_tpu_torch.parallel.sparse_ctr import SparseBatch
    from goctr_tpu_torch.parallel.train import local_batch

    return local_batch(SparseBatch(**{k: _t(v, mesh.device)
                                      for k, v in arrays.items()}), mesh)


def _gather_data(x: torch.Tensor, mesh: Mesh) -> np.ndarray:
    return _np(all_gather(x.contiguous(), mesh, DATA_AXIS))


def _state(model, opt_state, mesh: Mesh) -> dict:
    from goctr_tpu_torch.parallel.sparse_trainer import _gathered_state

    return {"dense": {k: _np(v) for k, v in model.state_dict().items()},
            "opt_state": [_np(x) for x in _gathered_state(
                opt_state, model, mesh)]}


def _mesh_case(case: dict, mesh: Mesh) -> dict:
    def ranks(group):
        return (None if group is None
                else sorted(dist.get_process_group_ranks(group)))
    out = {"rank": mesh.rank, "coords": mesh.coords,
           "data_group": ranks(mesh.data_group),
           "model_group": ranks(mesh.model_group)}
    for spec, devices in case.get("bad_specs", []):
        try:
            make_mesh(MeshSpec(*spec), devices=devices)
        except ValueError as e:
            out.setdefault("errors", []).append(str(e))
    return out


def _lookup_case(case: dict, mesh: Mesh) -> dict:
    from goctr_tpu_torch.parallel.embedding import sharded_lookup

    table = row_sharded(mesh).local(_t(case["table"], mesh.device))
    ids = _batch_part(case["ids"], mesh)
    out, over = sharded_lookup(table.contiguous(), ids, mesh,
                               dedup_cap=case.get("dedup_cap", 0),
                               with_overflow=True,
                               width=case.get("width", 0),
                               group=case.get("group", 1))
    return {"out": _gather_data(out, mesh), "overflow": int(over)}


def _batch_part(ids: np.ndarray, mesh: Mesh) -> torch.Tensor:
    from goctr_tpu_torch.core.meshes import batch_sharded
    return batch_sharded(mesh).local(_t(ids, mesh.device)).contiguous()


def _pooled_case(case: dict, mesh: Mesh) -> dict:
    from goctr_tpu_torch.parallel.embedding import sharded_pooled_lookup

    table = row_sharded(mesh).local(_t(case["table"], mesh.device))
    out = sharded_pooled_lookup(table.contiguous(),
                                _batch_part(case["ids"], mesh), mesh,
                                combiner=case["combiner"])
    return {"out": _gather_data(out, mesh)}


def _lookup_grad_case(case: dict, mesh: Mesh) -> dict:
    from goctr_tpu_torch.parallel.embedding import sharded_lookup

    table = row_sharded(mesh).local(_t(case["table"], mesh.device))
    table = table.contiguous().requires_grad_()
    ids = _batch_part(case["ids"], mesh)
    with torch.enable_grad():
        out = sharded_lookup(table, ids, mesh,
                             dedup_cap=case.get("dedup_cap", 0))
        (g,) = torch.autograd.grad(out.sum(), [table])
    g = psum(g, mesh, DATA_AXIS)
    return {"grad": _np(all_gather(g, mesh, MODEL_AXIS))}


def _model(case: dict, mesh: Mesh):
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR

    model = SparseCTR(**case["model"], device=mesh.device)
    if "dense" in case:
        model.load_state_dict({k: _t(v, mesh.device)
                               for k, v in case["dense"].items()})
    return model


def _dense_steps_case(case: dict, mesh: Mesh) -> dict:
    from goctr_tpu_torch.optim.optimizers import make_solver
    from goctr_tpu_torch.parallel.train import (
        dense_path_leaves, make_sharded_train_step)

    model = _model(case, mesh)
    vocab = case["table"].shape[0]
    table = row_sharded(mesh).local(_t(case["table"], mesh.device), 1)
    solver = make_solver("adam", case.get("lr", 1e-2))
    state = solver.init(dense_path_leaves(model, table))
    step = make_sharded_train_step(model, solver, mesh)
    steps = []
    for arrays in case["batches"]:
        loss, state = step(table, state, _batch(arrays, mesh))
        w = row_sharded(mesh).gather(table.detach(), vocab)
        steps.append(dict(_state(model, state, mesh),
                          loss=float(loss), table=_np(w)))
    return {"steps": steps}


def _sparse_steps_case(case: dict, mesh: Mesh) -> dict:
    from goctr_tpu_torch.ops.kernels.row_optimizer import (
        group_size, pack_table, pack_table_grouped)
    from goctr_tpu_torch.optim.optimizers import make_solver
    from goctr_tpu_torch.parallel.scanned import PACKED_MODES
    from goctr_tpu_torch.parallel.sparse_trainer import _gathered_table
    from goctr_tpu_torch.parallel.table_opt import TableOptConfig
    from goctr_tpu_torch.parallel.train import make_sharded_sparse_train_step

    model = _model(case, mesh)
    topt = TableOptConfig(**case["table_opt"])
    d = model.emb_dim
    packed = topt.update_mode in PACKED_MODES
    g = group_size(d) if topt.update_mode == "fused" else 1
    vocab = case["table"].shape[0]
    w = row_sharded(mesh).local(_t(case["table"], mesh.device),
                                g if packed else 1)
    a = torch.zeros(w.shape[0], device=mesh.device)
    if packed:
        table, acc = (pack_table_grouped(w, a) if g > 1
                      else pack_table(w, a)), None
    else:
        table, acc = w.clone(), a
    solver = make_solver("adam", case.get("lr", 1e-2))
    state = solver.init(model.param_leaves())
    step = make_sharded_sparse_train_step(model, solver, mesh, topt)
    steps = []
    for arrays in case["batches"]:
        with torch.no_grad():
            loss, state, over = step(table, state, acc, _batch(arrays, mesh))
        w_g, a_g = _gathered_table(table, acc, mesh, vocab, d,
                                   g if packed and g > 1 else 1,
                                   packed and g == 1)
        steps.append(dict(_state(model, state, mesh),
                          loss=float(loss), overflow=int(over), table=w_g,
                          acc=a_g))
    return {"steps": steps}


def _configs(case: dict):
    from goctr_tpu_torch.models.trainer import TrainerConfig
    from goctr_tpu_torch.parallel.table_opt import TableOptConfig

    topt = case.get("table_opt")
    return (TrainerConfig(**case["cfg"]),
            TableOptConfig(**topt) if topt is not None else None)


def _ranker_result(r, mesh: Mesh, test: Optional[dict],
                   batch_size: int) -> dict:
    from goctr_tpu_torch.parallel.sparse_trainer import (
        SparseSample, _gathered_table)

    vocab = r.model.item_vocab
    w, a = _gathered_table(r.table, r.acc, mesh, vocab, r.model.emb_dim,
                           r.packed_group, r.table_packed)
    out = dict(_state(r.model, r.opt_state, mesh),
               loss_curve=list(r.loss_curve), table=w,
               acc=None if r.acc is None and r.packed_group == 1 else a,
               overflow=r.lookup_overflow_max, packed_group=r.packed_group)
    if test is not None:
        out["predict"] = r.predict(SparseSample(**test),
                                   batch_size=batch_size)
    return out


def _train_case(case: dict, mesh: Mesh) -> dict:
    from goctr_tpu_torch.convert import sparse_ranker_from_jax
    from goctr_tpu_torch.models.io import load_sparse_checkpoint
    from goctr_tpu_torch.parallel.sparse_trainer import (
        SparseSample, train_sparse)

    cfg, topt = _configs(case)
    start = None
    if "load_from" in case:
        start, _, _ = load_sparse_checkpoint(case["load_from"], mesh)
    elif "start" in case:
        s = case["start"]
        start = sparse_ranker_from_jax(
            _model(dict(case, dense=s["dense"]), mesh), s["dense"],
            s["table"], s.get("acc"), s.get("opt_state"),
            s.get("loss_curve"), layout=s["layout"], mesh=mesh)
    r = train_sparse(_model(case, mesh), SparseSample(**case["sample"]),
                     mesh, cfg, table_opt=topt, resume_from=start)
    if "save_to" in case:
        r.save(case["save_to"], trainer_config=cfg, table_opt=topt)
    return _ranker_result(r, mesh, case.get("test"),
                          case.get("predict_batch", 128))


def _resume_case(case: dict, mesh: Mesh) -> dict:
    from goctr_tpu_torch.models.io import load_sparse_checkpoint
    from goctr_tpu_torch.parallel.sparse_trainer import (
        SparseSample, train_sparse)

    cfg, topt = _configs(case)
    sample = SparseSample(**case["sample"])
    k = case["split"]
    full = train_sparse(_model(case, mesh), sample, mesh, cfg,
                        table_opt=topt)
    train_sparse(_model(case, mesh), sample, mesh,
                 dataclasses.replace(cfg, epochs=k), table_opt=topt,
                 checkpoint_every=k, checkpoint_path=case["path"])
    loaded, tc, to = load_sparse_checkpoint(case["path"], mesh)
    resumed = train_sparse(_model(case, mesh), sample, mesh,
                           dataclasses.replace(tc, epochs=cfg.epochs - k),
                           table_opt=to, resume_from=loaded)
    same_state = all(torch.equal(a, b) for a, b in zip(resumed.opt_state,
                                                       full.opt_state))
    return {"full": _ranker_result(full, mesh, None, 0),
            "resumed": _ranker_result(resumed, mesh, None, 0),
            "same_table": bool(torch.equal(resumed.table, full.table)),
            "same_state": same_state}


CASES = {"mesh": _mesh_case, "lookup": _lookup_case,
         "pooled": _pooled_case, "lookup_grad": _lookup_grad_case,
         "dense_steps": _dense_steps_case,
         "sparse_steps": _sparse_steps_case, "train": _train_case,
         "resume": _resume_case}


def run_case(case: dict, mesh: Mesh) -> dict:
    """One case on this rank's shards of `mesh` (module docstring)."""
    return CASES[case["kind"]](case, mesh)


def rank_cases(devices: list, work: list) -> list[list[dict]]:
    """For each (spec, cases) of `work`, in order: build the (d, m) mesh
    over the launched ranks and run its cases (the function a `launch`
    runs on each rank). Returns each spec's results."""
    out = []
    for spec, cases in work:
        mesh = make_mesh(MeshSpec(*spec), devices=devices)
        out.append([run_case(c, mesh) for c in cases])
    return out
