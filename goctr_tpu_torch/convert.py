"""Carry the JAX package's SparseCTR parameters and trainer state into
the port.

The input is numpy, as the JAX side hands it over: the dense parameters
flattened by `goctr_tpu.models.io._flatten_params` (`att0`, `mlp.<i>`,
`bias.<i>`), the item table as `np.asarray(table)`, the adagrad
accumulator as `np.asarray(acc)`, and the solver state as
`[np.asarray(x) for x in jax.tree.leaves(opt_state)]`. Nothing here
imports JAX; a caller that holds JAX arrays converts them with numpy.
`scanned_from_jax` builds the TrainedScanned the port's scanned trainer
resumes from (`train_sparse_scanned(..., resume_from=...)`),
`sparse_ranker_from_jax` the TrainedSparseRanker of the mesh trainer
(`train_sparse(..., resume_from=...)`).
"""
from __future__ import annotations

import numpy as np
import torch

from goctr_tpu_torch.core.dtypes import resolve_device
from goctr_tpu_torch.core.meshes import single_device_mesh
from goctr_tpu_torch.ops.kernels.row_optimizer import LANES, group_size
from goctr_tpu_torch.parallel.scanned import TrainedScanned
from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
from goctr_tpu_torch.parallel.sparse_trainer import TrainedSparseRanker

LAYOUTS = ("plain", "packed", "grouped")


def params_from_jax(flat: dict[str, np.ndarray], table: np.ndarray,
                    layout: str = "plain",
                    device: str | torch.device = "cuda"
                    ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """(state_dict for SparseCTR.load_state_dict, float32 table) on
    `device`. `layout` names the table's layout: "plain" [V, D], "packed"
    [V, 128] (w | acc | pad) or "grouped" [ceil(V/G), 128] lines."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    table = np.asarray(table)
    if table.ndim != 2 or (layout != "plain" and table.shape[1] != LANES):
        raise ValueError(f"a {layout} table must be 2-D"
                         + ("" if layout == "plain" else f" with {LANES} "
                            "lanes") + f", got {table.shape}")
    dev = resolve_device(device)
    dense = {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
             for k, v in flat.items()}
    return dense, torch.from_numpy(np.array(table, np.float32)).to(dev)


def scanned_from_jax(model: SparseCTR, flat: dict[str, np.ndarray],
                     table: np.ndarray, acc: np.ndarray | None = None,
                     opt_state: list[np.ndarray] | None = None,
                     loss_curve: list[float] | None = None,
                     device: str | torch.device = "cuda") -> TrainedScanned:
    """A JAX TrainedScanned's state as the port's: `flat` dense parameters
    are loaded into `model` (moved to `device`), `table` is the JAX
    result's table — [V, D] with `acc` its [V] adagrad accumulator (a
    dedup result's [V + junk, D] and [V + junk] are taken as they are), or
    a grouped-resident result's [L, 128] lines (whose JAX `acc` is empty:
    it lives in the lines), told apart by the shape — and `opt_state` the
    solver state's leaves in JAX leaf order. The result can be passed to
    train_sparse_scanned as resume_from, saved, or served."""
    dev = resolve_device(device)
    d = model.emb_dim
    g = group_size(d)
    shape = np.shape(table)
    lines = g > 1 and len(shape) == 2 and shape[1] == LANES
    if not lines and (len(shape) != 2 or shape[1] != d):
        raise ValueError(f"table {shape} is neither [V, {d}] rows nor "
                         f"[L, {LANES}] lines: emb_dim {d} packs {g} rows "
                         "per line")
    packed_group = g if lines else 1
    dense, table_t = params_from_jax(
        flat, table, "grouped" if lines else "plain", device=dev)
    model.to(dev)
    model.load_state_dict(dense)
    acc_t = (torch.from_numpy(np.array(acc, np.float32)).to(dev)
             if acc is not None and np.size(acc) else None)
    state = (None if opt_state is None else
             [torch.from_numpy(np.array(x)).to(dev) for x in opt_state])
    return TrainedScanned(model=model, table=table_t,
                          loss_curve=list(loss_curve or []),
                          opt_state=state, acc=acc_t,
                          packed_group=packed_group)


def sparse_ranker_from_jax(model: SparseCTR, flat: dict[str, np.ndarray],
                           table: np.ndarray, acc: np.ndarray | None = None,
                           opt_state: list[np.ndarray] | None = None,
                           loss_curve: list[float] | None = None,
                           layout: str = "plain",
                           device: str | torch.device = "cuda"
                           ) -> TrainedSparseRanker:
    """A JAX TrainedSparseRanker's state as the port's, on the 1×1 mesh
    of `device`: `flat` dense parameters are loaded into `model` (moved to
    `device`); `table` is `np.asarray(params["item_table"])` in its
    `layout` — "plain" [V, D], "packed" [V, 128] (the JAX ranker's
    table_packed) or "grouped" lines (its packed_group > 1); `acc` its [V]
    adagrad accumulator; `opt_state` the solver state's leaves in JAX leaf
    order (on the dense path they include the table's). The result can be
    passed to train_sparse as resume_from, predict or be saved."""
    dev = resolve_device(device)
    d = model.emb_dim
    if layout == "grouped" and group_size(d) == 1:
        raise ValueError(f"emb_dim {d} packs one row a line: not grouped")
    dense, table_t = params_from_jax(flat, table, layout, device=dev)
    model.to(dev)
    model.load_state_dict(dense)
    acc_t = (torch.from_numpy(np.array(acc, np.float32)).to(dev)
             if acc is not None and np.size(acc) else None)
    state = (None if opt_state is None else
             [torch.from_numpy(np.array(x)).to(dev) for x in opt_state])
    return TrainedSparseRanker(
        model=model, table=table_t, mesh=single_device_mesh(dev),
        loss_curve=list(loss_curve or []), opt_state=state, acc=acc_t,
        packed_group=group_size(d) if layout == "grouped" else 1,
        table_packed=layout == "packed")
