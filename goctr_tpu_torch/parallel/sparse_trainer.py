"""The mesh trainer `train_sparse`, its result `TrainedSparseRanker` and
the raw-id sample (port of goctr_tpu/parallel/sparse_trainer.py).

The sample is copied to the device once (`_device_sample`); each step
gathers its rows there by the host shuffle's indices (`_put_batch`), so
the host never waits on a copy, and runs one of the two steps of
parallel/train.py:
table_opt=None trains the item table with the tower's solver (the dense
path: a [V, D] gradient and the solver's moments of it); a
TableOptConfig trains it by sparse row updates in the layout of its
update_mode (packed [V, 128] rows, grouped lines, or [V, D] with an
accumulator; grouped fused runs at a vocab of GROUPED_RESIDENT_MIN_V or
more draw their lines directly and keep them).

As in JAX: the batch size is the configured one (at most the rows); the
last batch is padded with item 0, label 0 and no behaviors, and its pad
rows enter the mean loss and the gradients (a reference fault the port
keeps so that trajectories compare, ROADMAP C); the epoch's cost is the
mean of each batch's loss weighted by its real rows, summed in float64.
The port keeps that sum and the overflow count on the device and reads
them back once per epoch, where JAX syncs every step; the numbers are
the same. The host waits on the card twice an epoch (the permutation's
upload at its start, that read at its end) and, on a mesh above 1×1
over gloo, at each staged collective of a step (parallel/train.py); no
other step operation waits.

Random streams: the shuffle is host numpy, `np.random.default_rng(seed)`
with one permutation an epoch, as in JAX, so both packages see the same
batches. Fresh parameters come from `trainer_generator(cfg, 0)` and epoch
e's dropout masks from `trainer_generator(cfg, e + 1)`, counting e from
the first epoch of the uninterrupted run (parallel/scanned.py); they
cannot match JAX's threefry streams, but a run resumed after k epochs
replays the shuffle, the dropout and the early-stop state and continues
the uninterrupted run bit for bit.

On a mesh above 1×1 (one process a rank, core/meshes.py) every rank draws
the same permutation and takes its data shard's rows of each padded
global batch (the batch size divisible by d, as in JAX); each rank draws
the fresh parameters from the same stream and keeps its model shard's
rows of the table (the vocab padded to m, or to m·G on grouped lines,
which a resident run draws shard by shard); dropout masks come from a
stream of the rank's data index. The grouped lines unpack shard by shard
at the end, with no cross-shard traffic. `predict` gathers the scores
over `data`, so every rank returns all n; `save` assembles the plain
table and accumulator over `model`, rank 0 writes and the others wait.
A resume_from on such a mesh holds this rank's shard (a ranker of the
same mesh shape: a finished run, a snapshot, load_sparse_checkpoint or
convert.sparse_ranker_from_jax); a change of layout gathers its plain
rows over `model` first.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from goctr_tpu_torch.core.meshes import (
    DATA_AXIS, MODEL_AXIS, Mesh, all_gather, barrier, row_sharded,
)
from goctr_tpu_torch.models.trainer import TrainerConfig
from goctr_tpu_torch.ops.kernels.row_optimizer import (
    group_size, pack_table, pack_table_grouped, unpack_table,
    unpack_table_grouped,
)
from goctr_tpu_torch.parallel import scanned
from goctr_tpu_torch.parallel.sparse_ctr import SparseBatch, SparseCTR
from goctr_tpu_torch.parallel.table_opt import TableOptConfig
from goctr_tpu_torch.parallel.train import (
    dense_path_leaves, local_batch, make_sharded_predict,
    make_sharded_sparse_train_step, make_sharded_train_step,
    table_state_slots,
)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class SparseSample:
    """Raw-feature sample set (the id-native analogue of TrainSample)."""
    user_profile: np.ndarray   # [N, U] float32
    behavior_ids: np.ndarray   # [N, T] int32, -1 padded
    item_ids: np.ndarray       # [N] int32
    ctx: np.ndarray            # [N, C] float32
    labels: np.ndarray         # [N] float32

    @property
    def rows(self) -> int:
        return self.item_ids.shape[0]


@dataclasses.dataclass
class TrainedSparseRanker:
    model: SparseCTR                    # holds the dense parameters
    # plain [V, D]; with packed_group > 1 grouped lines [L, 128]; with
    # table_packed one-row-per-line [V, 128] (w | acc | 0) rows
    table: torch.Tensor
    mesh: Mesh
    loss_curve: list[float]
    epoch_times: list[float] = dataclasses.field(default_factory=list)
    # solver state leaves in JAX leaf order: the dense parameters', and on
    # the dense path the table's between bias.* and mlp.*
    opt_state: Optional[list[torch.Tensor]] = dataclasses.field(
        default=None, repr=False)
    # [V] adagrad accumulator of a [V, D] table (sparse path); None when
    # it lives in the lines, or on the dense path
    acc: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                    repr=False)
    # max per-step count of unique ids the update exchange dropped (0 =
    # every batch fit exchange_cap; nonzero = grow it)
    lookup_overflow_max: int = 0
    packed_group: int = 1
    # mid-training snapshots of the packed modes only; results export
    # plain [V, D]
    table_packed: bool = False

    def save(self, path, trainer_config=None, table_opt=None) -> None:
        """Checkpoint (models/io.py sparse tier): plain [vocab, D] table and
        [vocab] acc whatever the layout, dense parameters, solver state,
        loss curve and the configs needed to resume."""
        from goctr_tpu_torch.models.io import save_sparse_checkpoint
        w, a = _gathered_table(self.table, self.acc, self.mesh,
                               self.model.item_vocab, self.model.emb_dim,
                               self.packed_group, self.table_packed)
        state = _gathered_state(self.opt_state, self.model, self.mesh)
        if self.mesh.rank == 0:
            save_sparse_checkpoint(path, self.model,
                                   self.model.state_dict(), w, a,
                                   self.loss_curve, opt_state=state,
                                   trainer_config=trainer_config,
                                   table_opt=table_opt)
        barrier(self.mesh)

    def predict(self, sample: SparseSample, batch_size: int = 8192
                ) -> np.ndarray:
        """Click probabilities [N] (the last batch padded, as in JAX); on
        a mesh above 1×1 every rank returns all N."""
        fn = make_sharded_predict(self.model, self.mesh,
                                  table_group=self.packed_group,
                                  table_packed=self.table_packed)
        n = sample.rows
        d = self.mesh.shape[DATA_AXIS]
        bs = max(d, (min(batch_size, n) // d) * d)
        data = _device_sample(sample, self.mesh.device)
        out = np.empty(n, np.float32)
        for s in range(0, n, bs):
            e = min(s + bs, n)
            batch = local_batch(_put_batch(data, slice(s, e), bs - (e - s)),
                                self.mesh)
            scores = all_gather(fn(self.table, batch), self.mesh, DATA_AXIS)
            out[s:e] = scores.cpu().numpy()[:e - s]
        return out


def _plain_rows(table: torch.Tensor, acc: Optional[torch.Tensor], d: int,
                packed_group: int, table_packed: bool):
    """This shard's rows of any table layout as ([rows, D] w, [rows] acc)
    on its device."""
    table = table.detach()
    if packed_group > 1:
        return unpack_table_grouped(table, table.shape[0] * packed_group, d)
    if table_packed:
        return unpack_table(table, d)
    return table, (acc if acc is not None
                   else torch.zeros(table.shape[0], device=table.device))


def _gathered_table(table, acc, mesh: Mesh, vocab: int, d: int,
                    packed_group: int, table_packed: bool):
    """The plain host ([vocab, D] w, [vocab] acc) from every model
    shard's rows (a collective: every rank calls it)."""
    w, a = _plain_rows(table, acc, d, packed_group, table_packed)
    rows = row_sharded(mesh)
    return (rows.gather(w, vocab).cpu().clone().numpy(),
            rows.gather(a, vocab).cpu().clone().numpy())


def _gathered_state(state, model: SparseCTR, mesh: Mesh):
    """The solver state with the table's leaves (the dense path's table
    moments) gathered over `model` and cut to the vocab."""
    if state is None:
        return None
    slots = set(table_state_slots(model, state))
    rows = row_sharded(mesh)
    return [rows.gather(x, model.item_vocab) if i in slots else x
            for i, x in enumerate(state)]


_BATCH_TYPES = {"user_profile": np.float32, "behavior_ids": np.int32,
                "item_ids": np.int32, "ctx": np.float32,
                "labels": np.float32}


def _device_sample(sample: SparseSample, device: torch.device
                   ) -> dict[str, torch.Tensor]:
    """The sample's arrays on `device` (float32 features and labels,
    int32 ids)."""
    return {name: torch.from_numpy(np.ascontiguousarray(
        getattr(sample, name), dtype)).to(device)
        for name, dtype in _BATCH_TYPES.items()}


def _put_batch(data: dict[str, torch.Tensor], sel, pad: int
               ) -> SparseBatch:
    """Rows `sel` (a slice or an index tensor on the data's device) of the
    device sample plus `pad` pad rows (behaviors -1, everything else 0)."""
    def take(name: str) -> torch.Tensor:
        x = data[name][sel]
        if pad:
            fill = -1 if name == "behavior_ids" else 0
            x = torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]),
                                         fill)])
        return x

    return SparseBatch(**{name: take(name) for name in _BATCH_TYPES})


def _start_table(model: SparseCTR, resume_from, mesh: Mesh,
                 cfg: TrainerConfig, sparse: bool, packed: bool, g: int,
                 resident: bool):
    """(table, acc) as the run trains them, fresh tensors: from
    resume_from's table in any layout, or drawn from the seed."""
    d = model.emb_dim
    dev = mesh.device
    m = mesh.shape[MODEL_AXIS]
    multiple = g if packed else 1          # rows a shard is padded to
    if resume_from is None:
        gen = scanned.trainer_generator(cfg, 0, dev)
        if resident:
            return model.init_params(gen, mesh, table_group=g), None
        w = model.init_params(gen, mesh, row_multiple=multiple)
        a = None
    elif resume_from.packed_group > 1 and g == resume_from.packed_group:
        return resume_from.table.to(dev, copy=True), None   # lines stay
    else:
        r = resume_from
        if m > 1:
            w, a = _reshard_rows(r, mesh, d, multiple)
        elif r.packed_group > 1:
            w, a = unpack_table_grouped(r.table.to(dev),
                                        r.table.shape[0] * r.packed_group, d)
        elif r.table_packed:
            w, a = unpack_table(r.table.to(dev), d)
        else:
            w, a = r.table.to(dev), r.acc
    if a is None:
        a = torch.zeros(w.shape[0], device=dev)
    a = a.to(dev)
    if packed and g > 1:
        return pack_table_grouped(w, a), None
    if packed:
        return pack_table(w, a), None
    w = w.detach().clone(memory_format=torch.contiguous_format)
    if not sparse:
        return w, None
    return w, a.clone()


def _reshard_rows(r: TrainedSparseRanker, mesh: Mesh, d: int,
                  multiple: int):
    """This rank's plain (w, a) rows for a layout padded to m·multiple
    rows, from resume_from's shards: in place when its rows already are
    that range, else gathered over `model` and cut."""
    if r.mesh.shape != mesh.shape:
        raise ValueError(f"resume_from lies on a {r.mesh.shape} mesh, the "
                         f"run on {mesh.shape}: load it from a checkpoint")
    w, a = _plain_rows(r.table.to(mesh.device), r.acc, d, r.packed_group,
                       r.table_packed)
    a = a.to(mesh.device)
    rows = row_sharded(mesh)
    v = r.model.item_vocab
    if w.shape[0] == rows.span(v, multiple)[1]:
        return w, a
    return (rows.local(rows.gather(w, v), multiple),
            rows.local(rows.gather(a, v), multiple))


def train_sparse(model: SparseCTR, sample: SparseSample, mesh: Mesh,
                 cfg: Optional[TrainerConfig] = None,
                 table_opt: Optional[TableOptConfig] = None,
                 resume_from: Optional[TrainedSparseRanker] = None,
                 checkpoint_every: int = 0, checkpoint_path=None,
                 epoch_hook=None) -> TrainedSparseRanker:
    """Train `model` on `sample` over `mesh`: on 1×1 the mesh's device,
    above it this rank's shards (module docstring; every rank calls it
    with the same arguments).

    table_opt=None: the dense path (the table trained by the tower's
    solver). A TableOptConfig: sparse row-wise updates (its update_mode,
    exchange_cap, rmw_impl; module docstring of parallel/train.py).

    resume_from: a TrainedSparseRanker (a finished run, an epoch_hook
    snapshot, models/io.load_sparse_checkpoint, convert.
    sparse_ranker_from_jax) in any table layout: its dense parameters
    (copied into `model`), table, accumulator and solver state are the
    start, and the shuffle, dropout and early-stop state are replayed;
    cfg.epochs counts ADDITIONAL epochs. resume_from is not modified
    (unless it shares `model`).

    checkpoint_every/checkpoint_path: every k epochs write a checkpoint
    (TrainedSparseRanker.save). epoch_hook(epoch, cost, ranker) runs after
    each epoch with a snapshot that shares the training table (valid until
    the next epoch starts).

    The result: the dense path's [V, D] table; the sparse path's [V', D]
    table and [V'] acc (V' = the vocab rounded up to whole lines on
    grouped lines), or the lines themselves (packed_group = G) of a
    resident grouped run.
    """
    cfg = cfg or TrainerConfig()
    dev = mesh.device
    model.to(dev)
    n = sample.rows
    n_data = mesh.shape[DATA_AXIS]
    bs = max(n_data, (min(cfg.batch_size, n) // n_data) * n_data)
    solver = scanned.make_trainer_solver(cfg)
    d, v = model.emb_dim, model.item_vocab
    sparse = table_opt is not None
    if sparse:
        scanned._check_supported(table_opt, d)
    packed = sparse and table_opt.update_mode in scanned.PACKED_MODES
    g = group_size(d) if packed and table_opt.update_mode == "fused" else 1
    resident = g > 1 and v >= scanned.GROUPED_RESIDENT_MIN_V
    prev_curve = list(resume_from.loss_curve) if resume_from else []
    done_epochs = len(prev_curve)
    if resume_from is not None and resume_from.model is not model:
        model.load_state_dict(resume_from.model.state_dict())
    table, acc = _start_table(model, resume_from, mesh, cfg, sparse,
                              packed, g, resident)
    leaves = (model.param_leaves() if sparse
              else dense_path_leaves(model, table))
    if resume_from is not None and resume_from.opt_state is not None:
        opt_state = [x.to(dev) for x in resume_from.opt_state]
        scanned._check_opt_state(opt_state, solver.init(
            [p.detach().to("meta") for p in leaves]))
    else:
        opt_state = solver.init(leaves)
    if sparse:
        step = make_sharded_sparse_train_step(model, solver, mesh, table_opt)
    else:
        step = make_sharded_train_step(model, solver, mesh)

    rng = np.random.default_rng(cfg.seed)
    best, no_improve = float("inf"), 0
    for _ in range(done_epochs if cfg.shuffle else 0):
        rng.permutation(n)
    for cost in prev_curve:
        if cost < best - cfg.tol:
            best, no_improve = cost, 0
        else:
            no_improve += 1
    loss_curve: list[float] = []
    epoch_times: list[float] = []
    overflow_max = 0
    n_batches = -(-n // bs)
    data = _device_sample(sample, dev)

    def live_ranker() -> TrainedSparseRanker:
        return TrainedSparseRanker(
            model=model, table=table, mesh=mesh,
            loss_curve=prev_curve + loss_curve, epoch_times=epoch_times,
            opt_state=opt_state, acc=acc, lookup_overflow_max=overflow_max,
            packed_group=g, table_packed=packed and g == 1)

    for epoch in range(cfg.epochs):
        te = time.perf_counter()
        order = torch.from_numpy(rng.permutation(n) if cfg.shuffle
                                 else np.arange(n)).to(dev)
        gen = scanned.trainer_generator(cfg, done_epochs + epoch + 1, dev)
        if mesh.index(DATA_AXIS):               # this data shard's masks
            gen.manual_seed(gen.initial_seed()
                            ^ (mesh.index(DATA_AXIS) << 40))
        tot = torch.zeros((), dtype=torch.float64, device=dev)
        overs = [torch.zeros((), dtype=torch.int32, device=dev)]
        for b in range(n_batches):
            idx = order[b * bs:(b + 1) * bs]
            size = idx.shape[0]
            batch = local_batch(_put_batch(data, idx, bs - size), mesh)
            if sparse:
                loss, opt_state, over = step(table, opt_state, acc, batch,
                                             gen)
                overs.append(over)
            else:
                loss, opt_state = step(table, opt_state, batch, gen)
            tot += loss.double() * size
        # the epoch's one host sync
        tot_h, over = torch.stack([tot, torch.stack(overs).max().double()
                                   ]).tolist()
        cost = tot_h / n
        if int(over) > overflow_max:
            overflow_max = int(over)
            log.warning("exchange_cap overflow: %d unique ids dropped in a "
                        "step — results are inexact, raise exchange_cap "
                        "(currently %d)", overflow_max,
                        table_opt.exchange_cap)
        loss_curve.append(cost)
        epoch_times.append(time.perf_counter() - te)
        if cost < best - cfg.tol:
            best, no_improve = cost, 0
        else:
            no_improve += 1
        if cfg.verbose:
            log.info("epoch %d | cost %.6f | %.2fs", epoch, cost,
                     epoch_times[-1])
        if epoch_hook is not None:
            epoch_hook(done_epochs + epoch, cost, live_ranker())
        if (checkpoint_every and checkpoint_path
                and (epoch + 1) % checkpoint_every == 0):
            live_ranker().save(checkpoint_path, trainer_config=cfg,
                               table_opt=table_opt)
        if cfg.early_stop and no_improve >= cfg.early_stop:
            break

    packed_group = 1
    if packed and g > 1 and resident:
        packed_group = g                # lines end to end
    elif packed and g > 1:
        table, acc = (x.contiguous() for x in unpack_table_grouped(
            table, table.shape[0] * g, d))
    elif packed:
        table, acc = (x.contiguous() for x in unpack_table(table, d))
    else:
        table = table.detach()
    return TrainedSparseRanker(model=model, table=table, mesh=mesh,
                               loss_curve=prev_curve + loss_curve,
                               epoch_times=epoch_times, opt_state=opt_state,
                               acc=acc, lookup_overflow_max=overflow_max,
                               packed_group=packed_group)
