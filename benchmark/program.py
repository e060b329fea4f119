"""The system under test: goctr_tpu_torch's scanned trainer,
`parallel.scanned.train_sparse_scanned`, driven as a user drives it.

A run hands the trainer the benchmark's own initial weights as a
`TrainedScanned` (`resume_from`), its draw as the NumPy `SparseSample`
the trainer takes, the configuration's `TableOptConfig` and a
`TrainerConfig(batch, epochs, early_stop=0, lr, shuffle=True, seed)`.
Every call gets a model of its own, so that the state handed in is never
trained in place.

Set-up drives that state through its first three steps in two calls of
the trainer, on rows that no other step sees: step 1 alone, so that its
gradients can be read from what the trainer returns, then steps 2 and 3
as one call of two batches, which hands its state from one step to the
next inside the trainer's own loop as the window does. From the results
it reads each call's loss (the trainer reports one an epoch: the mean of
the call's steps), each leaf's first gradient as the optimizer got it
(adam's first moment over 1 - beta1, with the l2 term; the table's, the
root of its accumulators' sum) and each leaf's change over the three
steps, and counts the launches of the port's counted kernels in the
two-step call. The window is one more call, over the whole draw,
resumed from the second call's result.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.reference import Readings, norm
from benchmark.trace import WINDOW_SPAN
from goctr_tpu_torch.models.trainer import TrainerConfig
from goctr_tpu_torch.parallel.scanned import (
    TableOptConfig, TrainedScanned, train_sparse_scanned,
)
from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
from goctr_tpu_torch.parallel.sparse_trainer import SparseSample

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# rows of the table read at a time when comparing it with another
TABLE_BLOCK = 1 << 22


def counted_kernels() -> dict:
    """The port's launch-counted kernel wrappers by name (each adds one to
    its `.launches` when it launches its kernel)."""
    from goctr_tpu_torch.ops.kernels import compact, din_attention
    from goctr_tpu_torch.ops.kernels import row_gather, row_optimizer
    from goctr_tpu_torch.ops.kernels import run_optimizer

    fns = (row_gather.gather_rows, din_attention.din_attention_pool,
           din_attention.din_attention_pool_bwd,
           row_optimizer.scatter_rows_packed, compact.compact_runsums_block,
           row_optimizer.apply_row_updates, row_optimizer.apply_line_updates,
           row_optimizer.apply_csum_updates, run_optimizer.apply_run_updates)
    return {f.__name__: f for f in fns}


def launches() -> dict:
    return {k: f.launches for k, f in counted_kernels().items()}


class Program:
    """One configuration's trainer on one device."""

    def __init__(self, config: dict, t: int, batch: int, cap: int,
                 device: torch.device):
        self.config, self.t, self.batch, self.dev = config, t, batch, device
        m, tr, to = config["model"], config["trainer"], config["table_opt"]
        self.model_kw = dict(
            item_vocab=m["item_vocab"], emb_dim=m["emb_dim"],
            u_profile_dim=m["u_profile_dim"], ctx_dim=m["ctx_dim"],
            behavior_len=t, hidden=tuple(m["hidden"]),
            activation=m["activation"], dropout_rate=m["dropout_rate"],
            compute_dtype=DTYPES[m["compute_dtype"]], pooling=m["pooling"])
        self.train_kw = dict(
            solver=tr["solver"], lr=tr["lr"], l2=tr["l2"], beta1=tr["beta1"],
            beta2=tr["beta2"], epsilon=tr["epsilon"],
            early_stop=tr["early_stop"], shuffle=tr["shuffle"])
        self.table_opt = TableOptConfig(
            kind=to["kind"], lr=to["lr"], eps=to["eps"],
            update_mode=to["update_mode"], sorted_gather=to["sorted_gather"],
            rmw_impl=to["rmw_impl"], compact_impl=to["compact_impl"],
            compact_cap=cap if to["compact_cap"] == "auto"
            else int(to["compact_cap"]))

    def model(self) -> SparseCTR:
        return SparseCTR(**self.model_kw, device=self.dev)

    def initial(self, dense0: dict, table0: torch.Tensor) -> TrainedScanned:
        """The benchmark's weights as the trainer's `resume_from`."""
        model = self.model()
        with torch.no_grad():
            for name, p in zip(leaf_order(model), model.param_leaves()):
                p.copy_(dense0[name])
        return TrainedScanned(
            model=model, table=table0, loss_curve=[],
            acc=torch.zeros(table0.shape[0], device=self.dev))

    def call(self, arrays: dict, rows: slice, epochs: int, seed: int,
             resume: TrainedScanned) -> TrainedScanned:
        sample = SparseSample(**{k: v[rows] for k, v in arrays.items()})
        cfg = TrainerConfig(batch_size=self.batch, epochs=epochs, seed=seed,
                            **self.train_kw)
        return train_sparse_scanned(self.model(), sample, cfg,
                                    self.table_opt, resume_from=resume,
                                    device=self.dev)

    def first_steps(self, arrays: dict, dense0: dict, table0: torch.Tensor,
                    seed: int, calls: tuple):
        """One trainer call of one epoch a entry of `calls`, each over that
        many batches of the next rows: (Readings, the last call's
        TrainedScanned, overflow max, the counted kernels' launches in
        the last call). The first gradients are read after the first
        call, which has to be one step."""
        state, start = self.initial(dense0, table0), 0
        losses, grad, over = [], {}, 0
        for i, steps in enumerate(calls):
            before = launches()
            state = self.call(arrays, slice(start, start + steps * self.batch),
                              1, seed, state)
            counted = {k: v - before[k] for k, v in launches().items()}
            start += steps * self.batch
            losses.append(state.loss_curve[-1])
            over = max(over, state.update_overflow_max)
            if i == 0:
                grad = self.first_grads(state)
        names = leaf_order(state.model)
        change = {n: norm(p.detach() - dense0[n])
                  for n, p in zip(names, state.model.param_leaves())}
        change["table"] = table_change(state, table0, self.config["model"])
        return Readings(losses, grad, change), state, over, counted

    def first_grads(self, state: TrainedScanned) -> dict:
        """Each leaf's gradient norm as the optimizer got it in one step:
        adam's first moment / (1 - beta1); the table's from its adagrad
        accumulators, each a row's ‖Σg‖² after one step."""
        names = leaf_order(state.model)
        k = len(names)
        mu = state.opt_state[1:1 + k]
        out = {n: norm(m) / (1.0 - self.train_kw["beta1"])
               for n, m in zip(names, mu)}
        _, acc = table_rows(state, self.config["model"])
        out["table"] = float(acc.double().sum().sqrt())
        return out

    def window(self, arrays: dict, epochs: int, seed: int,
               resume: TrainedScanned, span: str = WINDOW_SPAN):
        """One timed call over the whole draw, recorded as the host span
        `span` for a profiler: (result, seconds, the counted kernels'
        launches in the call)."""
        sync(self.dev)
        before = launches()
        t0 = time.perf_counter()
        with torch.profiler.record_function(span):
            out = self.call(arrays, slice(None), epochs, seed, resume)
            sync(self.dev)
        seconds = time.perf_counter() - t0
        return out, seconds, {k: v - before[k]
                              for k, v in launches().items()}


def leaf_order(model: SparseCTR) -> list[str]:
    """Names of model.param_leaves() (att0, bias.*, mlp.*)."""
    n = len(model.mlp)
    return (["att0"] + [f"bias.{i}" for i in range(n)]
            + [f"mlp.{i}" for i in range(n)])


def table_rows(state: TrainedScanned, model: dict):
    """([V, D] weights, [V] accumulators) of a result's table: a [V, D]
    table with its acc, or grouped lines [L, 128] of G = 128 // (D + 1)
    (weights | acc) groups a line, read here from that layout."""
    v, d = model["item_vocab"], model["emb_dim"]
    if state.packed_group == 1:
        return state.table[:v], state.acc[:v]
    g = state.packed_group
    lines = state.table.shape[0]
    grid = state.table[:, :g * (d + 1)].reshape(lines * g, d + 1)
    return grid[:v, :d], grid[:v, d]


def table_change(state: TrainedScanned, table0: torch.Tensor,
                 model: dict) -> float:
    """‖table - table0‖ over every row, in blocks of rows."""
    w, _ = table_rows(state, model)
    sq = 0.0
    for s in range(0, w.shape[0], TABLE_BLOCK):
        e = min(s + TABLE_BLOCK, w.shape[0])
        sq += float(((w[s:e] - table0[s:e]).double() ** 2).sum())
    return float(np.sqrt(sq))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
