"""One step of each training path that promises not to make the host wait
on the card, built at given widths from a seed, so that a check can run
it under a guard: `torch.cuda.set_sync_debug_mode("error")` on the card
(chip_smoke.py's [sync] phase, tests/test_torch_cuda.py) or a recorder
of the operations that wait (tests/test_torch_sync.py).

`step_cases(device, model, grouped, ranker, batch)` returns (name,
build) pairs in order; build() draws the case's state (the model, its
table in the layout of its update mode, the solver state, one batch on
the device) and returns step(), which runs one training step in place
and may be called again. Build and call each case in turn: at the
headline widths a case holds a few GB.

  scanned <variant>  parallel/scanned.py `train_step` (`model`'s widths)
                     in update_mode fused (compact_cap 0 and the split
                     update; xla and K9 compaction; K5), fused2 (K7),
                     runfused (K8), dedup, sorted and plain;
                     `grouped`'s widths (D < 64: lines of G rows) with the
                     split line update and K6
  mesh <mode>        `make_sharded_sparse_train_step` on the 1×1 mesh:
                     fused with K5, dedup, sorted and plain
  mesh dense         `make_sharded_train_step`: mean pooling (K3), adam
                     on every leaf, the table included
  ranker <model>     models/trainer.py `train_step` of MLPTower,
                     YoutubeDNN, DIN "xla" and DIN "pallas" (K2, K2b) at
                     `ranker`'s widths
  dedup_flat         parallel/embedding.py `_dedup_flat`, the capped
                     lookup's dedup, at a cap below the unique count
  scanned dlrm       (with `dlrm`, DLRMDCNv2's arguments) `train_step` of
                     DLRM-DCNv2 (parallel/dlrm.py): K3 over its bags,
                     adagrad, fused at D = 128 with the "xla" compaction
                     and the split update

The ids are zipf-like (a hot tenth of the vocabulary takes half the
draws) and a quarter of the behavior slots are -1 pads, which the sorted
mode's scatter drops.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

UNPACKED_MODES = ("dedup", "sorted", "plain")


def _ids(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    hot = rng.integers(0, max(vocab // 10, 1), shape)
    return np.where(rng.random(shape) < 0.5, hot,
                    rng.integers(0, vocab, shape)).astype(np.int32)


def sample_arrays(model_kw: dict, rows: int, seed: int = 0) -> dict:
    """SparseSample fields (numpy) of `rows` rows at `model_kw`'s widths:
    uniform profile and ctx, zipf-like ids, a quarter of the behaviors
    -1, labels 0 or 1."""
    rng = np.random.default_rng(seed)
    v, t = model_kw["item_vocab"], model_kw["behavior_len"]
    bids = _ids(rng, (rows, t), v)
    bids[rng.random((rows, t)) < 0.25] = -1
    return dict(
        user_profile=rng.random((rows, model_kw["u_profile_dim"]),
                                dtype=np.float32),
        behavior_ids=bids, item_ids=_ids(rng, rows, v),
        ctx=rng.random((rows, model_kw["ctx_dim"]), dtype=np.float32),
        labels=(rng.random(rows) < 0.5).astype(np.float32))


def sparse_batch(model_kw: dict, batch: int, device, seed: int = 0):
    """`sample_arrays` as a SparseBatch on `device`."""
    from goctr_tpu_torch.parallel.sparse_ctr import SparseBatch

    return SparseBatch(**{k: torch.from_numpy(a).to(device) for k, a in
                          sample_arrays(model_kw, batch, seed).items()})


def _scanned(device, model_kw: dict, batch: int, change: dict) -> Callable:
    from goctr_tpu_torch.models.trainer import (
        TrainerConfig, make_trainer_solver)
    from goctr_tpu_torch.parallel import scanned as sc
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
    from goctr_tpu_torch.parallel.table_opt import TableOptConfig

    gen = torch.Generator(device=device).manual_seed(0)
    model = SparseCTR(**model_kw, compute_dtype=torch.bfloat16,
                      device=device)
    topt = TableOptConfig(kind="adagrad", lr=0.05, **change)
    v, d = model.item_vocab, model.emb_dim
    g = sc.table_group(topt.update_mode, d)
    if g > 1:
        table, acc = model.init_params(gen, table_group=g), None
    else:
        rows = v + (sc.table_pad_rows(batch, model.behavior_len)
                    if topt.update_mode == "dedup" else 0)
        table, acc = sc._layout_table(
            topt.update_mode, model.init_params(gen),
            torch.zeros(v, device=device), v, rows)
    solver = make_trainer_solver(TrainerConfig())
    state = solver.init(model.param_leaves())
    b = sparse_batch(model_kw, batch, device)
    w = torch.ones(batch, device=device)

    def step():
        nonlocal state
        _, _, state = sc.train_step(
            model, table, solver, state, b.user_profile, b.behavior_ids,
            b.item_ids, b.ctx, b.labels, w, topt, gen, acc)

    return step


def _mesh_sparse(device, model_kw: dict, batch: int, change: dict
                 ) -> Callable:
    from goctr_tpu_torch.core.meshes import single_device_mesh
    from goctr_tpu_torch.models.trainer import (
        TrainerConfig, make_trainer_solver)
    from goctr_tpu_torch.ops.kernels.row_optimizer import pack_table
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
    from goctr_tpu_torch.parallel.table_opt import TableOptConfig
    from goctr_tpu_torch.parallel.train import make_sharded_sparse_train_step

    gen = torch.Generator(device=device).manual_seed(0)
    model = SparseCTR(**model_kw, compute_dtype=torch.bfloat16,
                      device=device)
    topt = TableOptConfig(kind="adagrad", lr=0.05, **change)
    w = model.init_params(gen)
    acc = torch.zeros(w.shape[0], device=device)
    if topt.update_mode in UNPACKED_MODES:
        table = w
    else:
        table, acc = pack_table(w, acc), None
        del w
    solver = make_trainer_solver(TrainerConfig())
    state = solver.init(model.param_leaves())
    step_fn = make_sharded_sparse_train_step(
        model, solver, single_device_mesh(device), topt)
    b = sparse_batch(model_kw, batch, device)

    def step():
        nonlocal state
        _, state, _ = step_fn(table, state, acc, b, gen)

    return step


def _mesh_dense(device, model_kw: dict, batch: int) -> Callable:
    from goctr_tpu_torch.core.meshes import single_device_mesh
    from goctr_tpu_torch.models.trainer import (
        TrainerConfig, make_trainer_solver)
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
    from goctr_tpu_torch.parallel.train import (
        dense_path_leaves, make_sharded_train_step)

    gen = torch.Generator(device=device).manual_seed(0)
    model = SparseCTR(**model_kw, compute_dtype=torch.bfloat16,
                      pooling="mean", device=device)
    table = model.init_params(gen)
    solver = make_trainer_solver(TrainerConfig(l2=0.0))
    state = solver.init(dense_path_leaves(model, table))
    step_fn = make_sharded_train_step(model, solver,
                                      single_device_mesh(device))
    b = sparse_batch(model_kw, batch, device)

    def step():
        nonlocal state
        _, state = step_fn(table, state, b, gen)

    return step


def _ranker(device, widths: dict, batch: int, name: str) -> Callable:
    from goctr_tpu_torch.models import DIN, MLPTower, YoutubeDNN
    from goctr_tpu_torch.models.base import SampleInfo, param_leaves
    from goctr_tpu_torch.models.trainer import (
        TrainerConfig, make_trainer_solver, train_step)

    u, t, d = widths["u_profile_dim"], widths["behavior_len"], \
        widths["behavior_dim"]
    it, cx = widths["i_feature_dim"], widths["c_feature_dim"]
    ub = u + t * d
    info = SampleInfo((0, u), (u, ub), (ub, ub + it), (ub + it, ub + it + cx))
    kw = dict(compute_dtype=torch.bfloat16)
    model = {"mlp": lambda: MLPTower(in_dim=info.width, **kw),
             "youtube": lambda: YoutubeDNN(u, t, d, it, cx, **kw),
             "din xla": lambda: DIN(u, t, d, it, cx, **kw),
             "din pallas": lambda: DIN(u, t, d, it, cx, **kw,
                                       attention_impl="pallas")}[name]()
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init_params(gen)
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    solver = make_trainer_solver(TrainerConfig())
    state = solver.init(leaves)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((batch, info.width),
                                    dtype=np.float32)).to(device)
    y = torch.from_numpy((rng.random(batch) < 0.5).astype(
        np.float32)).to(device)
    w = torch.ones(batch, device=device)

    def step():
        nonlocal state
        _, state = train_step(model, params, solver, state, x, y, w, info,
                              gen)

    return step


def _dlrm(device, dlrm_kw: dict, batch: int) -> Callable:
    from goctr_tpu_torch.models.trainer import (
        TrainerConfig, make_trainer_solver)
    from goctr_tpu_torch.parallel import scanned as sc
    from goctr_tpu_torch.parallel.dlrm import DLRMDCNv2
    from goctr_tpu_torch.parallel.table_opt import TableOptConfig

    gen = torch.Generator(device=device).manual_seed(0)
    model = DLRMDCNv2(**dlrm_kw, compute_dtype=torch.bfloat16,
                      device=device)
    v = model.item_vocab
    table, acc = sc._layout_table("fused", model.init_params(gen),
                                  torch.zeros(v, device=device), v, v)
    cap = -(-batch * model.ids_per_example // 2 // 1024) * 1024
    topt = TableOptConfig(kind="adagrad", lr=0.05, compact_cap=cap)
    solver = make_trainer_solver(TrainerConfig(solver="adagrad", l2=0.0))
    state = solver.init(model.param_leaves())
    rng = np.random.default_rng(0)
    ids = np.concatenate([_ids(rng, (batch, h), r) for h, r in
                          zip(model.hotness, model.rows)], 1)
    rows = [torch.from_numpy(a).to(device) for a in (
        rng.random((batch, model.dense_dim), dtype=np.float32), ids,
        (rng.random(batch) < 0.5).astype(np.float32),
        np.ones(batch, np.float32))]

    def step():
        nonlocal state
        _, _, state = sc.train_step(model, table, solver, state, *rows,
                                    topt, gen, acc)

    return step


def _dedup(device, model_kw: dict, batch: int) -> Callable:
    from goctr_tpu_torch.parallel.embedding import _dedup_flat

    flat = sparse_batch(model_kw, batch, device).behavior_ids.reshape(-1)
    cap = max(flat.shape[0] // 8, 1)

    def step():
        _dedup_flat(flat, cap)

    return step


def step_cases(device, model: dict, grouped: dict, ranker: dict,
               batch: int, dlrm: dict | None = None
               ) -> list[tuple[str, Callable[[], Callable]]]:
    """(name, build) of every case (module docstring): `model` and
    `grouped` are SparseCTR widths (`grouped` with emb_dim < 64, so that
    fused keeps lines of G > 1 rows), `ranker` DIN's (u_profile_dim,
    behavior_len, behavior_dim, i_feature_dim, c_feature_dim), `dlrm`
    DLRMDCNv2's arguments (emb_dim 128), or None for no DLRM case."""
    cap = -(-batch * (model["behavior_len"] + 1) // 4 // 1024) * 1024
    scanned = [
        ("fused split", model, {}),
        ("fused xla compaction", model, {"compact_cap": cap}),
        ("fused K9 compaction", model, {"compact_cap": cap,
                                        "compact_impl": "kernel"}),
        ("fused K5", model, {"rmw_impl": "kernel"}),
        ("fused2 K7", model, {"update_mode": "fused2"}),
        ("runfused K8", model, {"update_mode": "runfused"}),
        *((m, model, {"update_mode": m}) for m in UNPACKED_MODES),
        ("grouped split", grouped, {}),
        ("grouped K6", grouped, {"rmw_impl": "kernel"}),
    ]
    out = [(f"scanned {name}",
            lambda kw=kw, c=c: _scanned(device, kw, batch, c))
           for name, kw, c in scanned]
    out += [(f"mesh {name}", lambda c=c: _mesh_sparse(device, model, batch,
                                                      c))
            for name, c in (("fused K5", {"rmw_impl": "kernel"}),
                            *((m, {"update_mode": m})
                              for m in UNPACKED_MODES))]
    out += [("mesh dense", lambda: _mesh_dense(device, model, batch))]
    out += [(f"ranker {name}",
             lambda name=name: _ranker(device, ranker, batch, name))
            for name in ("mlp", "youtube", "din xla", "din pallas")]
    out += [("dedup_flat", lambda: _dedup(device, model, batch))]
    if dlrm is not None:
        out += [("scanned dlrm", lambda: _dlrm(device, dlrm, batch))]
    return out
