"""The sparse DIN ranker family: goctr_tpu_torch's `SparseCTR` with the DIN
pool, trained by the scanned trainer `parallel.scanned.train_sparse_scanned`
on a planted-parity click log (families/__init__.py has the interface).

The configuration's own keys: `model` (SparseCTR's widths, pooling and
compute dtype), `trainer` (the dense solver) and `table_opt` (the item
table's row update and its front end; `compact_cap` "auto" takes the
draw's).

Traffic: the one generator of this family, a planted-parity click log
drawn on the device from a seed, with the law of the JAX bench's draw
(frozen copy of goctr_tpu_torch/bench.py `make_workload` and
`_zipf_ranks`), rewritten in torch so that a run draws millions of rows
in a fraction of a second. A traffic file (`traffic/<name>.json`) gives
the sizes and the law's parameters; the model configuration gives the
vocabulary and the dense widths. Each row: a user (one of rows /
rows_per_user users, each with a taste parity), T behavior ids of which
a share `p_taste` carry the user's taste parity, one candidate item id, U
profile and C context floats in [0, 1), and a label. Ids are 2·slot +
parity, the slot drawn from a bounded zipf over ranks scattered across
the id space by a fixed multiplicative hash (`ids: zipf`), or uniformly
(`ids: uniform`). With `noisy`, the label is 1 with probability p_rule if
the item's parity is the user's taste (1 - p_rule if not), plus hot_bonus
for the top `hot_share` of ranks and minus cold_malus for the rest,
clipped to p_clip; without it the label is the rule itself. No behavior
is padded. The same seed gives the same rows on the same kind of device.

Weights, drawn on the device from the seed: dense leaves in the trainer's
leaf order (att0, bias.0.., mlp.0..): att0 = 1, biases 0, each tower
weight glorot-uniform [fan_in, fan_out]; the item table [V, D] float32
N(0, 0.01²), drawn in one call.

The program: a run hands the trainer the benchmark's own initial weights
as a `TrainedScanned` (`resume_from`), its draw as the NumPy
`SparseSample` the trainer takes, the configuration's `TableOptConfig`
and a `TrainerConfig(batch, epochs, early_stop=0, lr, shuffle=True,
seed)`. Every call gets a model of its own, so that the state handed in
is never trained in place. Set-up drives that state through its first
steps in the calls the harness asks for, on rows that no other step
sees: step 1 alone, so that its gradients can be read from what the
trainer returns, then steps 2 and 3 as one call of two batches, which
hands its state from one step to the next inside the trainer's own loop
as the window does. From the results it reads each call's loss (the
trainer reports one an epoch: the mean of the call's steps), each leaf's
first gradient as the optimizer got it (adam's first moment over 1 -
beta1, with the l2 term; the table's, the root of its accumulators' sum)
and each leaf's change over the three steps, and counts the launches of
the port's counted kernels in the last call. The window is one more
call, over the whole draw, resumed from the last call's result.

Counts, frozen: the work a training step needs, read the same whatever
implements it. `example_flops` is a copy of
goctr_tpu_torch/parallel/scanned.py `model_flops_per_example` (6 × the
tower's multiply-adds for forward and backward, plus the attention
pool's 12·T·D vector operations). `example_bytes` counts what
one step must move at the least, and no intermediate: each distinct row
of the batch read once and written once (D float32 weights and its
float32 accumulator), the batch's dataset rows read once, and the dense
parameters with adam's two moments read and written once a step. The
step's shares of the peaks therefore sit far below 100%.
`pool_needed_bytes` is the DIN pool's forward (K2) and backward (K2b) at
the compute dtype: K2 reads the behaviors, item, mask and att0 and writes
the pooled rows; K2b reads the pooled rows' gradient, behaviors, item,
att0 and mask and writes the behaviors', item's and att0's gradients.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from benchmark.families import Called, Inputs, Readings, norm
from benchmark.trace import WINDOW_SPAN
from goctr_tpu_torch.models.trainer import TrainerConfig
from goctr_tpu_torch.parallel.scanned import (
    TableOptConfig, TrainedScanned, train_sparse_scanned,
)
from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
from goctr_tpu_torch.parallel.sparse_trainer import SparseSample

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
# rows of the table read at a time when comparing it with another
TABLE_BLOCK = 1 << 22
# the control: the precision below the configurations' compute dtype, by
# its name in control.py's lines
CONTROLS = {"bfloat16": ("float8", "float8_e4m3")}


# --- traffic -------------------------------------------------------------

# Knuth's multiplicative hash (odd, coprime with every even half-vocab)
PRIME = 2_654_435_761
# rows drawn at a time: bounds the float64 temporaries of the zipf draw
CHUNK_ROWS = 1 << 20


@dataclasses.dataclass
class Draw:
    """One draw, on the device it was drawn on."""
    user_profile: torch.Tensor     # [N, U] float32
    behavior_ids: torch.Tensor     # [N, T] int32
    item_ids: torch.Tensor         # [N] int32
    ctx: torch.Tensor              # [N, C] float32
    labels: torch.Tensor           # [N] float32
    taste: torch.Tensor            # [N] int64, the row's user's parity

    @property
    def rows(self) -> int:
        return self.item_ids.shape[0]

    def host(self) -> dict:
        """The five arrays the trainer takes, as NumPy arrays."""
        return {k: getattr(self, k).cpu().numpy() for k in
                ("user_profile", "behavior_ids", "item_ids", "ctx",
                 "labels")}


def zipf_ranks(u: torch.Tensor, n_ranks: int, s: float) -> torch.Tensor:
    """Bounded-zipf ranks in [0, n_ranks) from uniforms u (float64):
    P(r) ≈ (r+1)^-s, the closed-form inverse CDF of the continuous
    bounded power law."""
    t = float(n_ranks) ** (1.0 - s)
    x = (1.0 - u * (1.0 - t)) ** (1.0 / (1.0 - s))
    return (x.to(torch.int64) - 1).clamp(0, n_ranks - 1)


def _ids(gen: torch.Generator, shape, half: int, law: dict):
    """(slot, rank) int64 tensors of `shape`."""
    dev = gen.device
    if law["ids"] == "zipf":
        u = torch.rand(shape, generator=gen, dtype=torch.float64,
                       device=dev)
        r = zipf_ranks(u, half, law["zipf_s"])
        return (r * PRIME) % half, r
    if law["ids"] == "uniform":
        v = torch.randint(0, half, shape, generator=gen, device=dev)
        return v, v
    raise ValueError(f"unknown id law {law['ids']!r}")


def draw_log(law: dict, vocab: int, u_dim: int, c_dim: int, seed: int,
             device: str | torch.device) -> Draw:
    """`law['rows']` rows of the traffic `law` over `vocab` ids."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) * 4 + 2)
    n, t = int(law["rows"]), int(law["t"])
    half = vocab // 2
    users = max(n // int(law["rows_per_user"]), 1)
    user_taste = torch.randint(0, 2, (users,), generator=gen, device=dev)
    uids = torch.randint(0, users, (n,), generator=gen, device=dev)
    taste = user_taste[uids]
    bids = torch.empty((n, t), dtype=torch.int32, device=dev)
    iids = torch.empty(n, dtype=torch.int32, device=dev)
    labels = torch.empty(n, dtype=torch.float32, device=dev)
    lo, hi = law["p_clip"]
    for s in range(0, n, CHUNK_ROWS):
        e = min(s + CHUNK_ROWS, n)
        m, ts = e - s, taste[s:e]
        b_slot, _ = _ids(gen, (m, t), half, law)
        b_alt, _ = _ids(gen, (m, t), half, law)
        coin = torch.rand((m, t), generator=gen, device=dev)
        alt_par = torch.randint(0, 2, (m, t), generator=gen, device=dev)
        bids[s:e] = torch.where(coin < law["p_taste"],
                                b_slot * 2 + ts[:, None],
                                b_alt * 2 + alt_par).to(torch.int32)
        i_slot, i_rank = _ids(gen, (m,), half, law)
        item = i_slot * 2 + torch.randint(0, 2, (m,), generator=gen,
                                          device=dev)
        iids[s:e] = item.to(torch.int32)
        parity = (item % 2) == ts
        if law["noisy"]:
            hot = i_rank < max(int(half * law["hot_share"]), 1)
            p_pos = (torch.where(parity, law["p_rule"], 1 - law["p_rule"])
                     + torch.where(hot, law["hot_bonus"],
                                   -law["cold_malus"])).clamp(lo, hi)
            labels[s:e] = (torch.rand(m, generator=gen, device=dev)
                           < p_pos).float()
        else:
            labels[s:e] = parity.float()
    prof = torch.rand((n, u_dim), generator=gen, device=dev)
    ctx = torch.rand((n, c_dim), generator=gen, device=dev)
    return Draw(prof, bids, iids, ctx, labels, taste)


def batch_ids(d: Draw, b: int, batch: int) -> torch.Tensor:
    """The ids of batch b in draw order (behaviors then items), int64."""
    sl = slice(b * batch, (b + 1) * batch)
    return torch.cat([d.behavior_ids[sl].reshape(-1),
                      d.item_ids[sl]]).long()


def unique_share(d: Draw, batch: int, batches: int = 4) -> float:
    """Mean share of a batch's ids that are distinct, over the draw's
    first `batches` batches of the cell's size."""
    k = max(1, min(batches, d.rows // batch))
    shares = []
    for b in range(k):
        ids = batch_ids(d, b, batch)
        shares.append(torch.unique(ids).numel() / ids.numel())
    return float(np.mean(shares))


def compact_cap(d: Draw, batch: int) -> int:
    """The JAX bench's auto compact_cap (frozen copy of bench.py
    `bench_compact_cap`): the first batch's distinct ids + 15%, rounded
    up to a multiple of 1024."""
    uniq0 = torch.unique(batch_ids(d, 0, batch)).numel()
    return -(-int(uniq0 * 1.15) // 1024) * 1024


def draw(config: dict, law: dict, seed: int, device) -> Inputs:
    m = config["model"]
    d = draw_log(law, m["item_vocab"], m["u_profile_dim"], m["ctx_dim"],
                 seed, device)
    return Inputs(d.host(), d.rows, compact_cap(d, law["batch"]),
                  unique_share(d, law["batch"]))


# --- weights -------------------------------------------------------------

TABLE_SCALE = 0.01


class Weights(NamedTuple):
    dense: dict                   # {leaf name: float32 tensor}
    table: torch.Tensor           # [V, D] float32


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed) * 4 + 1)
    return gen


def draw_dense(model: dict, t: int, seed: int, device) -> dict:
    """{leaf name: float32 tensor} on `device`."""
    gen = _generator(seed, device)
    dims = layer_dims(model)
    out = {"att0": torch.ones(t, device=device)}
    for i in range(len(dims) - 1):
        out[f"bias.{i}"] = torch.zeros(dims[i + 1], device=device)
    for i in range(len(dims) - 1):
        bound = math.sqrt(6.0 / (dims[i] + dims[i + 1]))
        u = torch.rand((dims[i], dims[i + 1]), generator=gen,
                       device=device)
        out[f"mlp.{i}"] = u.mul_(2.0 * bound).sub_(bound)
    return out


def draw_table(model: dict, t: int, seed: int, device) -> torch.Tensor:
    """The [V, D] float32 table. Drawn after the dense leaves from the same
    generator, so it is the same tensor whenever it is drawn again."""
    gen = _generator(seed, device)
    dims = layer_dims(model)
    for i in range(len(dims) - 1):           # advance past the dense draw
        torch.rand((dims[i], dims[i + 1]), generator=gen, device=device)
    table = torch.randn((model["item_vocab"], model["emb_dim"]),
                        generator=gen, device=device)
    return table.mul_(TABLE_SCALE)


def initial(config: dict, law: dict, seed: int, device) -> Weights:
    m, t = config["model"], law["t"]
    return Weights(draw_dense(m, t, seed, device),
                   draw_table(m, t, seed, device))


def control(config: dict) -> tuple[str, str]:
    return CONTROLS[config["model"]["compute_dtype"]]


# --- the program ---------------------------------------------------------

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

    def __init__(self, config: dict, law: dict, inputs: Inputs,
                 device: torch.device):
        t, batch, cap = law["t"], law["batch"], inputs.cap
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

    def first_steps(self, arrays: dict, weights: Weights, seed: int,
                    calls: tuple):
        """One trainer call of one epoch a entry of `calls`, each over that
        many batches of the next rows: (Readings, the last call's
        TrainedScanned, overflow max, the counted kernels' launches in
        the last call). The first gradients are read after the first
        call, which has to be one step."""
        dense0, table0 = weights
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
               resume: TrainedScanned, span: str = WINDOW_SPAN) -> Called:
        """One timed call over the whole draw, recorded as the host span
        `span` for a profiler; the trainer's result is dropped at once."""
        sync(self.dev)
        before = launches()
        t0 = time.perf_counter()
        with torch.profiler.record_function(span):
            out = self.call(arrays, slice(None), epochs, seed, resume)
            sync(self.dev)
        seconds = time.perf_counter() - t0
        return Called(out.loss_curve[len(resume.loss_curve):],
                      out.epoch_times, out.update_overflow_max, seconds,
                      {k: v - before[k] for k, v in launches().items()})


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


# --- the rows of each set-up step -----------------------------------------

def trainer_order(seed: int, epochs_done: int, n: int, shuffle: bool,
                  device: torch.device) -> torch.Tensor:
    """The order in which the trainer takes the n rows of a call's epoch,
    as goctr_tpu_torch documents it (parallel/scanned.py
    `trainer_generator`, `epoch_order`; frozen copy): a randperm from a
    generator on the device seeded seed × 1,000,003 + the epochs already
    in the state handed in."""
    if not shuffle:
        return torch.arange(n, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 1_000_003 + epochs_done)
    return torch.randperm(n, generator=gen, device=device)


def warm_batches(config: dict, law: dict, inputs: Inputs, seed: int,
                 calls: tuple, device: torch.device) -> list:
    """The first steps' batches, on the rows the trainer gives each step:
    each call of `calls` trains on the next rows of the draw, one epoch."""
    batch, out, start = law["batch"], [], 0
    shuffle = config["trainer"]["shuffle"]
    for done, steps in enumerate(calls):
        order = trainer_order(seed, done, steps * batch, shuffle, device)
        rows = (order + start).cpu().numpy()
        for s in range(steps):
            idx = rows[s * batch:(s + 1) * batch]
            out.append({k: torch.from_numpy(v[idx]).to(device)
                        for k, v in inputs.arrays.items()})
        start += steps * batch
    return out


# --- counts ----------------------------------------------------------------

def layer_dims(model: dict) -> list[int]:
    concat = model["u_profile_dim"] + 2 * model["emb_dim"] + model["ctx_dim"]
    return [concat, *model["hidden"], 1]


def dense_params(model: dict, t: int) -> int:
    """Dense parameters: the tower's weights and biases and att0 [T]."""
    dims = layer_dims(model)
    return t + sum(dims[i] * dims[i + 1] + dims[i + 1]
                   for i in range(len(dims) - 1))


def example_flops(model: dict, t: int) -> float:
    dims = layer_dims(model)
    macs = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    return 6.0 * macs + 3.0 * (4.0 * t * model["emb_dim"])


def dataset_bytes_per_example(model: dict, t: int) -> float:
    """A row of the dataset: profile, ctx and label float32, T behavior
    ids and one item id int32."""
    return (model["u_profile_dim"] + model["ctx_dim"] + 1) * 4.0 + (t + 1) * 4.0


def example_bytes(model: dict, t: int, batch: int,
                  unique_share: float) -> float:
    """Bytes a step needs, over its batch's examples; unique_share is the
    share of a batch's T + 1 ids a row that are distinct."""
    d = model["emb_dim"]
    rows = unique_share * batch * (t + 1)
    table = 2.0 * rows * (4.0 * d + 4.0)
    dense = 2.0 * 3.0 * 4.0 * dense_params(model, t)
    return (table + dense) / batch + dataset_bytes_per_example(model, t)


def pool_needed_bytes(model: dict, t: int, batch: int) -> float:
    """K2 + K2b bytes of one step (module docstring)."""
    e = DTYPE_BYTES[model["compute_dtype"]]
    d = model["emb_dim"]
    beh, row, mask, att0 = batch * t * d * e, batch * d * e, batch * t * 4, t * 4
    fwd = beh + row + mask + att0 + row
    bwd = row + beh + row + att0 + mask + beh + row + att0
    return float(fwd + bwd)


def flops_per_example(config: dict, law: dict) -> float:
    return example_flops(config["model"], law["t"])


def needed_bytes_per_example(config: dict, law: dict,
                             inputs: Inputs) -> float:
    return example_bytes(config["model"], law["t"], law["batch"],
                         inputs.unique_share)


def kernel_bytes(config: dict, law: dict) -> dict:
    """K2 + K2b's bytes a step, which `din_pool_roofline` reads."""
    return {"din_pool": pool_needed_bytes(config["model"], law["t"],
                                          law["batch"])}
