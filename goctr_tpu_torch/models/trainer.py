"""The dense rankers' trainer and its result (port of
goctr_tpu/models/trainer.py: TrainerConfig :36-60, TrainedRanker :63-146,
train_ranker :167-299).

The whole dataset lives on the device: x is uploaded once in
`cfg.store_dtype` (float16 halves what the ML-20M protocol's 281-column
rows pin; each batch is upcast to float32 on gather) and a Python loop
walks the batches: gather rows → forward → BCE-with-logits → autograd →
solver step on the parameter leaves, in place. The host syncs once per
epoch (`float(cost)`, as the JAX trainer does at :263). Padded tail rows
carry weight 0 in the loss (the reference zero-pads and trains on them,
model.go:357-371, which neither package copies). The JAX trainer also
pads the feature width to 128 lanes, a TPU tiling device that changes
no result; the port does not.

Early stopping matches the reference: epoch train cost plateau with a
patience counter (model.go:198-209). With `checkpoint_every` and
`checkpoint_dir` a full checkpoint (models/io.py) is written every that
many epochs. On resume the loss curve continues the prior one.

Random streams: fresh parameters come from a generator seeded with
`cfg.seed`; each epoch's permutation (`torch.randperm`) and the dropout
masks from two more, seeded from `cfg.seed` and the epochs already done.
None can match JAX's threefry streams, so parity tests carry parameters
across (convert.ranker_from_jax) and run with shuffle=False and dropout 0.
`TrainerConfig`'s fields and defaults are the JAX package's, so a
checkpoint's `trainer_config` is read by either package; the scanned
SparseCTR trainer (parallel/scanned.py) reads it too.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from goctr_tpu_torch.core.dtypes import resolve_device
from goctr_tpu_torch.models.base import (
    RankModel, SampleInfo, TrainSample, param_leaves, split_blocks,
)
from goctr_tpu_torch.ops.losses import bce_loss
from goctr_tpu_torch.optim.optimizers import Solver, make_solver
from goctr_tpu_torch.optim.schedules import make_schedule

log = logging.getLogger(__name__)

STORE_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                "bfloat16": torch.bfloat16}
UPLOAD_ROWS = 1 << 16       # rows cast and copied to the device at a time


@dataclasses.dataclass
class TrainerConfig:
    batch_size: int = 200          # reference dinimpl_test.go:38
    epochs: int = 200
    early_stop: int = 20           # 0 disables (model.go:205)
    solver: str = "adam"
    lr: float = 1e-3
    lr_schedule: str = "constant"
    power_t: float = 0.5
    l2: float = 1e-4               # classic L2, added before the solver
    weight_decay: float = 0.0
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    shuffle: bool = True
    seed: int = 0
    tol: float = 0.0               # min improvement to reset patience
    verbose: bool = False
    checkpoint_every: int = 0      # epochs between auto-checkpoints (0=off)
    checkpoint_dir: str = ""       # where periodic checkpoints land
    store_dtype: str = "float32"   # float32 | float16 | bfloat16


def make_trainer_solver(cfg: TrainerConfig) -> Solver:
    """The solver the trainers use for `cfg`."""
    schedule = make_schedule(cfg.lr_schedule, cfg.lr, cfg.power_t)
    return make_solver(cfg.solver, schedule, l2=cfg.l2,
                       weight_decay=cfg.weight_decay, momentum=cfg.momentum,
                       beta1=cfg.beta1, beta2=cfg.beta2, epsilon=cfg.epsilon)


def torch_store_dtype(name: str) -> torch.dtype:
    if name not in STORE_DTYPES:
        raise ValueError(f"store_dtype must be one of {tuple(STORE_DTYPES)}"
                         f", got {name!r}")
    return STORE_DTYPES[name]


def upload_rows(x: np.ndarray, rows: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """x [n, W] → a [rows, W] tensor of `dtype` on `device` (rows ≥ n,
    the rest zero), copied UPLOAD_ROWS rows at a time and cast on the
    device, so the host never holds a second copy of x."""
    n, width = x.shape
    out = torch.zeros((rows, width), dtype=dtype, device=device)
    for s in range(0, n, UPLOAD_ROWS):
        chunk = np.ascontiguousarray(x[s:s + UPLOAD_ROWS], dtype=np.float32)
        out[s:s + chunk.shape[0]].copy_(torch.from_numpy(chunk).to(device))
    return out


def blocks_of(x: torch.Tensor, info: SampleInfo, behavior_len: int):
    """The model's inputs from rows x: (x,) for whole-row models
    (behavior_len 0, MLPTower), else the four blocks."""
    if behavior_len == 0:
        return (x,)
    return split_blocks(x, info, behavior_len)


def _bucket(n: int, cap: int = 8192) -> int:
    """Smallest power-of-two ≥ n (from 128), capped: predict pads every
    chunk to this many rows, as the JAX package does to compile once."""
    b = 128
    while b < n and b < cap:
        b *= 2
    return b


def _params_on(params: dict, device: torch.device) -> dict:
    """A fresh copy of a params dict on `device` (float32 leaves)."""
    if isinstance(params, dict):
        return {k: _params_on(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_params_on(v, device) for v in params]
    return params.detach().to(device=device, dtype=torch.float32, copy=True)


@dataclasses.dataclass
class TrainedRanker:
    model: RankModel
    params: dict
    info: SampleInfo
    behavior_len: int
    loss_curve: list[float]
    epoch_times: list[float] = dataclasses.field(default_factory=list)
    opt_state: Optional[list[torch.Tensor]] = dataclasses.field(
        default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return param_leaves(self.params)[0].device

    @torch.no_grad()
    def _scores(self, xb: torch.Tensor) -> torch.Tensor:
        blocks = blocks_of(xb, self.info, self.behavior_len)
        return torch.sigmoid(self.model.apply(self.params, blocks,
                                              train=False))

    def predict(self, x: np.ndarray, batch_size: int = 8192) -> np.ndarray:
        """Scores [N] in [0,1], chunk by chunk from the host, each chunk
        zero-padded to the bucket batch size (reference zero-pad
        semantics, model.go:357-371)."""
        n = x.shape[0]
        if n == 0:
            return np.zeros(0, np.float32)
        dev = self.device
        out = np.empty(n, dtype=np.float32)
        bs = min(batch_size, _bucket(n, cap=batch_size))
        for start in range(0, n, bs):
            chunk = np.zeros((bs, x.shape[1]), np.float32)
            rows = min(bs, n - start)
            chunk[:rows] = x[start:start + rows]
            scores = self._scores(torch.from_numpy(chunk).to(dev))
            out[start:start + rows] = scores[:rows].cpu().numpy()
        return out

    def predict_logits(self, x: np.ndarray) -> np.ndarray:
        probs = np.clip(self.predict(x), 1e-7, 1 - 1e-7)
        return np.log(probs / (1 - probs))

    def predict_all(self, x: np.ndarray, batch_size: int = 65536,
                    store_dtype: str = "float16") -> np.ndarray:
        """Whole-matrix scoring: x uploads once in `store_dtype` (padded
        to a whole number of batches), then the batches run on the device
        and the scores come back in one copy. The eval-scale path."""
        n = x.shape[0]
        if n == 0:
            return np.zeros(0, np.float32)
        bs = min(batch_size, n)
        n_b = -(-n // bs)
        dev = self.device
        xd = upload_rows(x, n_b * bs, torch_store_dtype(store_dtype), dev)
        scores = torch.empty(n_b * bs, dtype=torch.float32, device=dev)
        for b in range(n_b):
            scores[b * bs:(b + 1) * bs] = self._scores(
                xd[b * bs:(b + 1) * bs].float())
        return scores[:n].cpu().numpy()


def run_generators(cfg: TrainerConfig, epochs_done: int,
                   device: torch.device):
    """(shuffle, dropout) generators of a run that starts after
    `epochs_done` epochs."""
    base = (cfg.seed * 1_000_003 + epochs_done) * 2
    return (torch.Generator(device=device).manual_seed(base),
            torch.Generator(device=device).manual_seed(base + 1))


def train_step(model: RankModel, params: dict, solver: Solver,
               opt_state: list[torch.Tensor], xb: torch.Tensor,
               yb: torch.Tensor, wb: torch.Tensor, info: SampleInfo,
               generator: Optional[torch.Generator]):
    """One step on float32 rows xb, labels yb and weights wb: the
    weighted BCE, its gradient with respect to the parameter leaves
    (which require grad), one solver step added to them in place.
    Returns (loss, new solver state) on the device; the host never waits
    on the card here (each dense ranker's step runs under
    torch.cuda.set_sync_debug_mode("error") in chip_smoke.py's [sync]
    phase, parallel/step_cases.py)."""
    leaves = param_leaves(params)
    with torch.enable_grad():
        logits = model.apply(params, blocks_of(xb, info, model.behavior_len),
                             train=True, generator=generator)
        loss = bce_loss(logits, yb, wb)
        grads = torch.autograd.grad(loss, leaves)
    updates, opt_state = solver.update(grads, opt_state, leaves)
    with torch.no_grad():
        for p, u in zip(leaves, updates):
            p.add_(u)
    return loss.detach(), opt_state


def start_params(model: RankModel, cfg: TrainerConfig, solver: Solver,
                 resume_from: Optional[TrainedRanker], device: torch.device):
    """(params, solver state) a run starts from: fresh from a generator
    seeded with cfg.seed, or copies of resume_from's (its state checked
    against the solver's). The parameter leaves require grad."""
    if resume_from is not None:
        params = _params_on(resume_from.params, device)
    else:
        params = model.init_params(
            torch.Generator(device=device).manual_seed(cfg.seed))
    leaves = param_leaves(params)
    opt_state = solver.init(leaves)
    if resume_from is not None and resume_from.opt_state is not None:
        if len(resume_from.opt_state) != len(opt_state):
            raise ValueError(
                f"resume_from.opt_state has {len(resume_from.opt_state)} "
                f"leaves; the {cfg.solver} solver of these parameters has "
                f"{len(opt_state)}")
        opt_state = [s.detach().to(device, copy=True)
                     for s in resume_from.opt_state]
    for p in leaves:
        p.requires_grad_(True)
    return params, opt_state


def train_ranker(model: RankModel, sample: TrainSample,
                 cfg: Optional[TrainerConfig] = None,
                 resume_from: Optional[TrainedRanker] = None, *,
                 device: str | torch.device = "cuda") -> TrainedRanker:
    """Train `model` on `sample` on `device`, or resume: pass a prior
    TrainedRanker carrying params + optimizer state (true mid-training
    resume, which the reference's weights-only JSON snapshots cannot do).
    resume_from is not modified: its params and state are copied."""
    cfg = cfg or TrainerConfig()
    dev = resolve_device(device)
    n = sample.x.shape[0]
    bs = min(cfg.batch_size, n)
    n_batches = -(-n // bs)
    n_pad = n_batches * bs

    x = upload_rows(sample.x, n_pad, torch_store_dtype(cfg.store_dtype),
                    dev)
    y = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    y[:n] = torch.from_numpy(
        np.ascontiguousarray(sample.y, dtype=np.float32).ravel()).to(dev)
    w = torch.cat([torch.ones(n, device=dev),
                   torch.zeros(n_pad - n, device=dev)])

    solver = make_trainer_solver(cfg)
    params, opt_state = start_params(model, cfg, solver, resume_from, dev)
    n_prev = len(resume_from.loss_curve) if resume_from is not None else 0
    shuffle_gen, drop_gen = run_generators(cfg, n_prev, dev)
    info, behavior_len = sample.info, model.behavior_len

    best_cost = float("inf")
    no_improve = 0
    loss_curve: list[float] = []
    epoch_times: list[float] = []
    t0 = time.perf_counter()
    for epoch in range(cfg.epochs):
        te = time.perf_counter()
        perm = (torch.randperm(n_pad, generator=shuffle_gen, device=dev)
                if cfg.shuffle else None)
        losses = []
        for b in range(n_batches):
            if perm is None:
                sl = slice(b * bs, (b + 1) * bs)
                xb, yb, wb = x[sl].float(), y[sl], w[sl]
            else:
                idx = perm[b * bs:(b + 1) * bs]
                xb, yb, wb = x[idx].float(), y[idx], w[idx]
            loss, opt_state = train_step(model, params, solver, opt_state,
                                         xb, yb, wb, info, drop_gen)
            losses.append(loss)
        cost = float(torch.stack(losses).mean())   # the epoch's one sync
        epoch_times.append(time.perf_counter() - te)
        loss_curve.append(cost)
        if cost < best_cost - cfg.tol:
            best_cost = cost
            no_improve = 0
        else:
            no_improve += 1
        if cfg.verbose:
            log.info("epoch %d | no_improve %d | cost %.6f", epoch,
                     no_improve, cost)
        if (cfg.checkpoint_every and cfg.checkpoint_dir
                and (epoch + 1) % cfg.checkpoint_every == 0):
            from goctr_tpu_torch.models.io import save_checkpoint
            save_checkpoint(cfg.checkpoint_dir, TrainedRanker(
                model=model, params=params, info=info,
                behavior_len=behavior_len,
                loss_curve=(resume_from.loss_curve if resume_from else [])
                + loss_curve, opt_state=opt_state), trainer_config=cfg)
        if cfg.early_stop and no_improve >= cfg.early_stop:
            if cfg.verbose:
                log.info("early stop at epoch %d", epoch)
            break
    if cfg.verbose:
        log.info("trained %d epochs in %.2fs (%.0f examples/s)",
                 len(loss_curve), time.perf_counter() - t0,
                 len(loss_curve) * n / max(time.perf_counter() - t0, 1e-9))
    for p in param_leaves(params):
        p.requires_grad_(False)
    if resume_from is not None:
        loss_curve = resume_from.loss_curve + loss_curve
    return TrainedRanker(
        model=model, params=params, info=info, behavior_len=behavior_len,
        loss_curve=loss_curve, epoch_times=epoch_times, opt_state=opt_state)
