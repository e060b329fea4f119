"""The DLRM-DCNv2 family: goctr_tpu_torch's `DLRMDCNv2`
(parallel/dlrm.py), MLPerf Training's recommendation model, trained by the
scanned trainer `parallel.scanned.train_sparse_scanned` on multi-hot
traffic drawn from the seed (families/__init__.py has the interface).

The configuration's own keys: the model's widths under MLPerf's
torchrec_dlrm argument names (dense_in_features, embedding_dim,
num_embeddings_per_feature, multi_hot_sizes, dense_arch_layer_sizes,
over_arch_layer_sizes with its final 1, dcn_num_layers,
dcn_low_rank_dim), `rows_f<i>`, the rows this card holds of feature i
where it holds a share of the published count, `compute_dtype`, `trainer`
(the dense solver) and `table_opt` (the table's row update; `compact_cap`
"auto" takes the draw's).

Traffic (`traffic/<name>.json`): `rows` examples, each with one bag of
multi_hot_sizes[f] ids a feature, no pads. Feature f's ids are bounded-zipf
ranks (`zipf_s`) over the feature's held rows, each rank's row fixed by a
multiplicative hash (rank · PRIME mod rows; PRIME is prime, so every rank
has a row of its own) so that hot rows lie scattered across the table. The
13 dense features are log(1 + c) of counts c = floor(exp(mu_j + sigma ·
z)), z standard normal, mu_j rising evenly from `dense_mu` [0] to [1]
over the columns. The label is 1 with probability sigmoid(label_base +
label_ids · s / sqrt(F) + label_dense · (mean dense feature -
dense_center)), s the sum over the features of +1 for an even rank and
-1 for an odd one of the bag's first id: a signal that the tables and
the bottom MLP can learn. Everything is drawn on the device in one pass
of chunks; the same seed gives the same rows on the same kind of device.

Weights, drawn on the device from the seed: dense leaves in the model's
leaf order as torchrec draws them (bottom and top MLPs: weights and biases
U(±1/sqrt(fan_in)); cross net: V and W xavier-normal, biases 0), then the
table feature by feature, U(±1/sqrt(N_f)) with N_f the feature's published
row count (the held rows are a share of that table).

The program: as the sparse_din family drives it (see there; the zipf
law, the weights' generator, the warm batches' order and the sync are
that family's own functions): the benchmark's initial weights handed to
the trainer as a `TrainedScanned` (`resume_from`), the draw as the NumPy
`DLRMSample` the trainer takes, step 1 alone, steps 2-3 as one call, then
the window over the whole draw. The first gradients are read from
adagrad's state after step 1 (each leaf's Σg², whose root is |g|; the
table's, its accumulators).

Counts, frozen: `example_flops` is 6 × the multiply-adds of the bottom
MLP, the cross net (two products of 3,456 × 512 a layer) and the top MLP;
`example_bytes` counts each distinct row of a batch read and written once
(128 float32 weights and the float32 accumulator), the dataset row read
once, and the dense parameters and adagrad's state read and written once
a step. `bag_pool_bytes`, K3's needed bytes a step (`bag_pool_roofline`):
each distinct row of a batch read once (512 B), its 4-byte ids, and the
[B, F, 128] float32 output written; the distinct rows are the draw law's
expectation, Σ over the ranks of 1 - (1 - p_r)^n with the law's exact
rank probabilities, so that hot rows served from L2 can never read above
the roofline.
"""
from __future__ import annotations

import functools
import math
import time

import numpy as np
import torch

from benchmark.families import Called, Inputs, Readings, norm
from benchmark.families.dlrm_dcnv2_reference import layers
from benchmark.families.sparse_din import (
    CONTROLS, DTYPES, PRIME, TABLE_BLOCK, _generator, sync, warm_batches,
    zipf_ranks,
)
from benchmark.trace import WINDOW_SPAN
from goctr_tpu_torch.models.trainer import TrainerConfig
from goctr_tpu_torch.parallel.dlrm import DLRMDCNv2, DLRMSample
from goctr_tpu_torch.parallel.scanned import (
    TableOptConfig, TrainedScanned, train_sparse_scanned,
)


# --- traffic -------------------------------------------------------------

# rows drawn at a time: bounds the float64 temporaries of the zipf draw
CHUNK_ROWS = 1 << 18


def rank_probs(n_ranks: int, s: float) -> np.ndarray:
    """P(rank = r) of `zipf_ranks`: with F(y) = (1 - y^(1-s)) / (1 -
    n^(1-s)), P(rank <= r) = F(r + 2), the last rank taking the rest."""
    y = np.arange(1, n_ranks + 1, dtype=np.float64)
    cdf = (1.0 - y ** (1.0 - s)) / (1.0 - float(n_ranks) ** (1.0 - s))
    cdf[-1] = 1.0
    return np.diff(np.concatenate([[0.0], cdf]))


@functools.lru_cache(maxsize=8)
def _distinct(n_draws: int, n_ranks: int, s: float) -> float:
    p = rank_probs(n_ranks, s)
    return float(-np.expm1(n_draws * np.log1p(-np.minimum(p, 1.0 - 1e-16)))
                 .sum())


def expected_distinct(config: dict, law: dict) -> float:
    """The expected distinct rows of one batch under the draw law."""
    lay = layers(config)
    return sum(_distinct(law["batch"] * h, r, law["zipf_s"])
               for h, r in zip(lay["hotness"], lay["rows"]))


def draw_rows(config: dict, law: dict, seed: int, device) -> dict:
    """`law['rows']` examples as device tensors: dense [N, 13] float32,
    ids [N, K] int32 (each feature's own), labels [N] float32."""
    lay = layers(config)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) * 4 + 2)
    n, hot, rows = int(law["rows"]), lay["hotness"], lay["rows"]
    ids = torch.empty((n, sum(hot)), dtype=torch.int32, device=dev)
    signal = torch.zeros(n, device=dev)
    for s in range(0, n, CHUNK_ROWS):
        e = min(s + CHUNK_ROWS, n)
        k0 = 0
        for h, r in zip(hot, rows):
            u = torch.rand((e - s, h), generator=gen, dtype=torch.float64,
                           device=dev)
            rank = zipf_ranks(u, r, law["zipf_s"])
            ids[s:e, k0:k0 + h] = ((rank * PRIME) % r).to(torch.int32)
            signal[s:e] += 1.0 - 2.0 * (rank[:, 0] % 2).float()
            k0 += h
    mu = torch.linspace(law["dense_mu"][0], law["dense_mu"][1],
                        lay["dense"], device=dev)
    z = torch.randn((n, lay["dense"]), generator=gen, device=dev)
    dense = torch.log1p(torch.floor(torch.exp(mu + law["dense_sigma"] * z)))
    logit = (law["label_base"]
             + law["label_ids"] * signal / math.sqrt(len(hot))
             + law["label_dense"] * (dense.mean(1) - law["dense_center"]))
    labels = (torch.rand(n, generator=gen, device=dev)
              < torch.sigmoid(logit)).float()
    return {"dense": dense, "ids": ids, "labels": labels}


def global_ids(config: dict, ids: torch.Tensor) -> torch.Tensor:
    """Each feature's ids [B, K] → rows of the one table, int64."""
    lay = layers(config)
    first = np.concatenate([[0], np.cumsum(lay["rows"])[:-1]])
    base = torch.from_numpy(np.repeat(first, lay["hotness"])).to(ids.device)
    return ids.long() + base


def unique_share(config: dict, ids: torch.Tensor, batch: int,
                 batches: int = 4) -> float:
    """Mean share of a batch's ids that are distinct rows, over the draw's
    first `batches` batches."""
    k = max(1, min(batches, ids.shape[0] // batch))
    return float(np.mean([
        torch.unique(global_ids(config, ids[b * batch:(b + 1) * batch]))
        .numel() / (batch * ids.shape[1]) for b in range(k)]))


def compact_cap(config: dict, ids: torch.Tensor, batch: int) -> int:
    """The first batch's distinct rows + 15%, rounded up to a multiple of
    1024 (the sparse_din family's rule)."""
    uniq0 = torch.unique(global_ids(config, ids[:batch])).numel()
    return -(-int(uniq0 * 1.15) // 1024) * 1024


def draw(config: dict, law: dict, seed: int, device) -> Inputs:
    d = draw_rows(config, law, seed, device)
    ids, batch = d["ids"], law["batch"]
    return Inputs({k: v.cpu().numpy() for k, v in d.items()},
                  ids.shape[0], compact_cap(config, ids, batch),
                  unique_share(config, ids, batch))


# --- weights -------------------------------------------------------------

def _uniform(gen, shape, bound, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    return u.mul_(2.0 * bound).sub_(bound)


def initial(config: dict, law: dict, seed: int, device):
    """(dense leaves by name, the [V, 128] float32 table)."""
    lay = layers(config)
    gen = _generator(seed, device)
    dense = {}
    bd = [lay["dense"]] + lay["bottom"]
    td = [(len(lay["hotness"]) + 1) * lay["dim"]] + lay["top"] + [1]
    x = td[0]
    for name, dims in (("bottom", bd), ("top", td)):
        for i in range(len(dims) - 1):
            bound = 1.0 / math.sqrt(dims[i])
            dense[f"{name}_w.{i}"] = _uniform(gen, (dims[i], dims[i + 1]),
                                              bound, device)
            dense[f"{name}_b.{i}"] = _uniform(gen, (dims[i + 1],), bound,
                                              device)
    rank = lay["cross_rank"]
    for i in range(lay["cross_layers"]):
        for name, shape in (("cross_v", (x, rank)), ("cross_w", (rank, x))):
            std = math.sqrt(2.0 / (shape[0] + shape[1]))
            dense[f"{name}.{i}"] = torch.randn(
                shape, generator=gen, device=device).mul_(std)
        dense[f"cross_b.{i}"] = torch.zeros(x, device=device)
    table = torch.empty((sum(lay["rows"]), lay["dim"]), device=device)
    r0 = 0
    for n, n_pub in zip(lay["rows"], config["num_embeddings_per_feature"]):
        table[r0:r0 + n] = _uniform(gen, (n, lay["dim"]),
                                    1.0 / math.sqrt(n_pub), device)
        r0 += n
    return dense, table


def control(config: dict) -> tuple[str, str]:
    return CONTROLS[config["compute_dtype"]]


# --- the program ---------------------------------------------------------

def counted_kernels() -> dict:
    """The port's launch-counted kernel wrappers on this model's path by
    name (each adds one to its `.launches` when it launches its kernel):
    K3 (the bags), the "xla" compaction, and the split update's K1 read
    and K4 write."""
    from goctr_tpu_torch.ops.kernels import compact_xla, embedding_lookup
    from goctr_tpu_torch.ops.kernels import row_gather, row_optimizer

    fns = (embedding_lookup.fused_gather_pool, compact_xla.compact_xla_rows,
           row_gather.gather_rows, row_optimizer.scatter_rows_packed)
    return {f.__name__: f for f in fns}


def launches() -> dict:
    return {k: f.launches for k, f in counted_kernels().items()}


class Program:
    """One configuration's trainer on one device."""

    def __init__(self, config: dict, law: dict, inputs: Inputs,
                 device: torch.device):
        lay = layers(config)
        tr, to = config["trainer"], config["table_opt"]
        self.config, self.batch, self.dev = config, law["batch"], device
        self.vocab = sum(lay["rows"])
        self.model_kw = dict(
            hotness=lay["hotness"], rows=lay["rows"], emb_dim=lay["dim"],
            dense_dim=lay["dense"], bottom=lay["bottom"],
            cross_layers=lay["cross_layers"], cross_rank=lay["cross_rank"],
            top=lay["top"], compute_dtype=DTYPES[lay["compute_dtype"]],
            init_rows=config["num_embeddings_per_feature"])
        self.train_kw = dict(solver=tr["solver"], lr=tr["lr"], l2=tr["l2"],
                             epsilon=tr["epsilon"],
                             early_stop=tr["early_stop"],
                             shuffle=tr["shuffle"])
        self.table_opt = TableOptConfig(
            kind=to["kind"], lr=to["lr"], eps=to["eps"],
            update_mode=to["update_mode"], sorted_gather=to["sorted_gather"],
            rmw_impl=to["rmw_impl"], compact_impl=to["compact_impl"],
            compact_cap=inputs.cap if to["compact_cap"] == "auto"
            else int(to["compact_cap"]))

    def model(self) -> DLRMDCNv2:
        return DLRMDCNv2(**self.model_kw, device=self.dev)

    def initial(self, dense0: dict, table0: torch.Tensor) -> TrainedScanned:
        """The benchmark's weights as the trainer's `resume_from`."""
        model = self.model()
        with torch.no_grad():
            for name, p in zip(model.leaf_names(), model.param_leaves()):
                p.copy_(dense0[name])
        return TrainedScanned(model=model, table=table0, loss_curve=[],
                              acc=torch.zeros(self.vocab, device=self.dev))

    def call(self, arrays: dict, rows: slice, epochs: int, seed: int,
             resume: TrainedScanned) -> TrainedScanned:
        sample = DLRMSample(**{k: v[rows] for k, v in arrays.items()})
        cfg = TrainerConfig(batch_size=self.batch, epochs=epochs, seed=seed,
                            **self.train_kw)
        return train_sparse_scanned(self.model(), sample, cfg,
                                    self.table_opt, resume_from=resume,
                                    device=self.dev)

    def first_steps(self, arrays: dict, weights, seed: int, calls: tuple):
        """One trainer call of one epoch a entry of `calls`, each over that
        many batches of the next rows: (Readings, the last call's
        TrainedScanned, overflow max, the counted kernels' launches in
        the last call). The first gradients are read after the first
        call, which has to be one step."""
        dense0, table0 = weights
        state, start = self.initial(dense0, table0), 0
        losses, grad, over = [], {}, 0
        counted = {}
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
        change = {n: norm(p.detach() - dense0[n]) for n, p in zip(
            state.model.leaf_names(), state.model.param_leaves())}
        change["table"] = table_change(state.table, table0)
        return Readings(losses, grad, change), state, over, counted

    def first_grads(self, state: TrainedScanned) -> dict:
        """Each leaf's gradient norm as the optimizer got it in one step:
        the root of adagrad's Σg² (the solver's first leaves); the
        table's from its accumulators, each a row's ‖Σg‖² after one
        step."""
        names = state.model.leaf_names()
        out = {n: float(s.double().sum().sqrt())
               for n, s in zip(names, state.opt_state[:len(names)])}
        out["table"] = float(state.acc.double().sum().sqrt())
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


def table_change(table: torch.Tensor, table0: torch.Tensor) -> float:
    """‖table - table0‖ over every row, in blocks of rows."""
    sq = 0.0
    for s in range(0, table0.shape[0], TABLE_BLOCK):
        e = min(s + TABLE_BLOCK, table0.shape[0])
        sq += float(((table[s:e] - table0[s:e]).double() ** 2).sum())
    return float(np.sqrt(sq))


# --- counts ----------------------------------------------------------------

def _products(lay: dict) -> list:
    """(in, out) of every matrix product of the forward."""
    bd = [lay["dense"]] + lay["bottom"]
    x = (len(lay["hotness"]) + 1) * lay["dim"]
    td = [x] + lay["top"] + [1]
    cross = [(x, lay["cross_rank"]), (lay["cross_rank"], x)]
    return ([(bd[i], bd[i + 1]) for i in range(len(bd) - 1)]
            + cross * lay["cross_layers"]
            + [(td[i], td[i + 1]) for i in range(len(td) - 1)])


def dense_params(lay: dict) -> int:
    """Dense parameters: the products' weights and every bias (the cross
    net's V has none)."""
    x = (len(lay["hotness"]) + 1) * lay["dim"]
    biases = (sum(lay["bottom"]) + sum(lay["top"]) + 1
              + x * lay["cross_layers"])
    return sum(a * b for a, b in _products(lay)) + biases


def example_flops(config: dict) -> float:
    return 6.0 * sum(a * b for a, b in _products(layers(config)))


def example_bytes(config: dict, law: dict, unique_share: float) -> float:
    """Bytes a step needs, over its batch's examples (module
    docstring)."""
    lay = layers(config)
    k = sum(lay["hotness"])
    rows = unique_share * law["batch"] * k
    table = 2.0 * rows * (4.0 * lay["dim"] + 4.0)
    dense = 2.0 * 2.0 * 4.0 * dense_params(lay)
    dataset = (lay["dense"] + 1) * 4.0 + k * 4.0
    return (table + dense) / law["batch"] + dataset


def bag_pool_bytes(config: dict, law: dict) -> float:
    """K3's needed bytes a step (module docstring)."""
    lay = layers(config)
    b, k = law["batch"], sum(lay["hotness"])
    out = b * len(lay["hotness"]) * lay["dim"] * 4.0
    return expected_distinct(config, law) * lay["dim"] * 4.0 + 4.0 * b * k \
        + out


def flops_per_example(config: dict, law: dict) -> float:
    return example_flops(config)


def needed_bytes_per_example(config: dict, law: dict,
                             inputs: Inputs) -> float:
    return example_bytes(config, law, inputs.unique_share)


def kernel_bytes(config: dict, law: dict) -> dict:
    """K3's bytes a step, which `bag_pool_roofline` reads."""
    return {"bag_pool": bag_pool_bytes(config, law)}
