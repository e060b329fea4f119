"""Carry the JAX package's parameters and trainer state into the port:
SparseCTR's, the dense rankers' (MLPTower, YoutubeDNN, DIN), a trained
Word2Vec's, the sklearn-style MLPs' and Neural's.

The input is numpy, as the JAX side hands it over: the dense parameters
flattened by `goctr_tpu.models.io._flatten_params` (`att0`, `mlp.<i>`,
`bias.<i>`), the item table as `np.asarray(table)`, the adagrad
accumulator as `np.asarray(acc)`, and the solver state as
`[np.asarray(x) for x in jax.tree.leaves(opt_state)]`. Nothing here
imports JAX; a caller that holds JAX arrays converts them with numpy.
`scanned_from_jax` builds the TrainedScanned the port's scanned trainer
resumes from (`train_sparse_scanned(..., resume_from=...)`),
`sparse_ranker_from_jax` the TrainedSparseRanker of the mesh trainer
(`train_sparse(..., resume_from=...)`), and `ranker_from_jax` the
TrainedRanker of the dense trainer (`train_ranker(..., resume_from=...)`)
from a JAX TrainedRanker's `_flatten_params(params)` and
`jax.tree.leaves(opt_state)`. `word2vec_from_jax`, `mlp_from_jax` and
`neural_from_jax` build trained port models from a JAX Word2Vec's tables
and dictionary, an MLPClassifier's or MLPRegressor's fitted attributes,
and a Neural's weights and config.
"""
from __future__ import annotations

import numpy as np
import torch

from goctr_tpu_torch.core.dtypes import resolve_device
from goctr_tpu_torch.core.meshes import Mesh, row_sharded, single_device_mesh
from goctr_tpu_torch.embedding.dictionary import Dictionary
from goctr_tpu_torch.embedding.word2vec import Word2Vec, Word2VecOptions
from goctr_tpu_torch.models.base import SampleInfo
from goctr_tpu_torch.models.io import _unflatten_params
from goctr_tpu_torch.models.mlp_classifier import MLPClassifier
from goctr_tpu_torch.models.mlp_regressor import MLPRegressor
from goctr_tpu_torch.models.neural import Neural, NeuralConfig
from goctr_tpu_torch.models.trainer import TrainedRanker, _params_on
from goctr_tpu_torch.ops.kernels.row_optimizer import LANES, group_size
from goctr_tpu_torch.parallel.scanned import TrainedScanned
from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
from goctr_tpu_torch.parallel.sparse_trainer import TrainedSparseRanker
from goctr_tpu_torch.parallel.train import table_state_slots

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
                           device: str | torch.device = "cuda",
                           mesh: Mesh | None = None
                           ) -> TrainedSparseRanker:
    """A JAX TrainedSparseRanker's state as the port's, on the 1×1 mesh
    of `device`, or on `mesh` (its device): `flat` dense parameters are
    loaded into `model` (moved to the device); `table` is
    `np.asarray(params["item_table"])` in its `layout` — "plain" [V, D],
    "packed" [V, 128] (the JAX ranker's table_packed) or "grouped" lines
    (its packed_group > 1); `acc` its [V] adagrad accumulator; `opt_state`
    the solver state's leaves in JAX leaf order (on the dense path they
    include the table's). On a mesh with m > 1 model shards this rank
    keeps its rows (or lines) of the table, of acc and of the solver
    state's table leaves, as JAX shards them over `model`: a ranker of
    any JAX topology, its table padded to it or not, lands on the mesh's
    padding (rows or lines padded with zeros to m). The
    result can be passed to train_sparse as resume_from, predict or be
    saved."""
    mesh = mesh or single_device_mesh(device)
    dev = mesh.device
    d = model.emb_dim
    if layout == "grouped" and group_size(d) == 1:
        raise ValueError(f"emb_dim {d} packs one row a line: not grouped")
    dense, table_t = params_from_jax(flat, table, layout, device=dev)
    model.to(dev)
    model.load_state_dict(dense)
    def rows(x: torch.Tensor) -> torch.Tensor:
        return row_sharded(mesh).local(x, 1)
    acc_t = (rows(torch.from_numpy(np.array(acc, np.float32))).to(dev)
             if acc is not None and np.size(acc) else None)
    state = None
    if opt_state is not None:
        state = [torch.from_numpy(np.array(y)) for y in opt_state]
        slots = set(table_state_slots(model, state))
        state = [(rows(x) if i in slots else x).to(dev)
                 for i, x in enumerate(state)]
    return TrainedSparseRanker(
        model=model, table=rows(table_t).contiguous(), mesh=mesh,
        loss_curve=list(loss_curve or []), opt_state=state, acc=acc_t,
        packed_group=group_size(d) if layout == "grouped" else 1,
        table_packed=layout == "packed")


def ranker_from_jax(model, flat_params: dict[str, np.ndarray],
                    opt_leaves: list[np.ndarray] | None, info: SampleInfo,
                    behavior_len: int, loss_curve: list[float] | None = None,
                    *, device: str | torch.device = "cuda") -> TrainedRanker:
    """A JAX TrainedRanker's state as the port's, on `device`: `model` the
    port's MLPTower / YoutubeDNN / DIN of the same config, `flat_params`
    the JAX params flattened (`att0`, `bias.<i>`, `mlp.<i>`),
    `opt_leaves` the solver state's leaves in JAX leaf order (or None),
    `info` and `behavior_len` the JAX ranker's. The result can be passed
    to train_ranker as resume_from, predict or be saved."""
    dev = resolve_device(device)
    params = _params_on(_unflatten_params(flat_params), dev)
    state = (None if opt_leaves is None else
             [torch.from_numpy(np.array(x)).to(dev) for x in opt_leaves])
    return TrainedRanker(model=model, params=params, info=info,
                         behavior_len=behavior_len,
                         loss_curve=list(loss_curve or []), opt_state=state)


def word2vec_from_jax(w_in: np.ndarray, w_out: np.ndarray,
                      id2word: list, counts, opts: dict,
                      device: str | torch.device = "cuda") -> Word2Vec:
    """A trained port Word2Vec from a JAX Word2Vec's `w_in`, `w_out`,
    `dictionary.id2word` and `dictionary.counts`, and its options as a
    dict (`dataclasses.asdict(model.opts)`). HS models get their Huffman
    paths rebuilt from the counts, as training builds them."""
    d = Dictionary()
    d.id2word = list(id2word)
    d.word2id = {w: i for i, w in enumerate(d.id2word)}
    d.counts = [int(c) for c in counts]
    model = Word2Vec(Word2VecOptions(**opts), device=device)
    model.dictionary = d
    model._init_state(d.counts_array(), np.random.default_rng(0))
    model.w_in = np.array(w_in, np.float32)
    model.w_out = np.array(w_out, np.float32)
    return model


def mlp_from_jax(coefs: list[np.ndarray], intercepts: list[np.ndarray],
                 out_activation: str, classes=None,
                 device: str | torch.device = "cuda", **params):
    """A fitted port MLPClassifier, or MLPRegressor when `out_activation`
    is "identity", from a JAX model's `coefs_`, `intercepts_`,
    `out_activation_` and `classes_` (classifiers); `params` are its
    constructor arguments (`get_params()`)."""
    cls = MLPRegressor if out_activation == "identity" else MLPClassifier
    m = cls(**params, device=device)
    m.coefs_ = [np.array(w, np.float32) for w in coefs]
    m.intercepts_ = [np.array(b, np.float32) for b in intercepts]
    m.out_activation_ = out_activation
    if cls is MLPClassifier:
        m.classes_ = np.asarray(classes)
    m._multiclass = out_activation == "softmax"
    return m


def neural_from_jax(weights: list[np.ndarray], biases: list[np.ndarray],
                    config: dict, device: str | torch.device = "cuda"
                    ) -> Neural:
    """A port Neural from a JAX Neural's `weights`, `biases` and config
    (`dataclasses.asdict(net.config)`)."""
    net = Neural(NeuralConfig(**config), device=device)
    net.weights = [np.array(w, np.float32) for w in weights]
    net.biases = [np.array(b, np.float32) for b in biases]
    return net
