"""Streaming trainer for datasets larger than device memory (port of
goctr_tpu/models/streaming.py).

The resident trainer (models/trainer.py) keeps the whole dataset on the
device. This variant streams fixed-size row chunks host→device, double
buffered: each chunk is padded into a pinned host buffer (x, then y and
the row weight as two more columns) and copied on a side stream while
the previous chunk trains, and the training stream waits only for its
own chunk's copy. On the CPU the chunks are copied in order.

Chunks are shuffled at two levels per epoch: chunk order (from
`np.random.default_rng(cfg.seed)`, the JAX trainer's own draw, so the
order matches it exactly) and the row permutation within each chunk (the
run's shuffle generator). Every batch of a padded chunk trains, pad rows
with weight 0, as the JAX trainer's chunk scan does. The epoch cost is
the mean of the chunks' mean batch losses.
"""
from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from goctr_tpu_torch.core.dtypes import resolve_device
from goctr_tpu_torch.models.base import RankModel, TrainSample, param_leaves
from goctr_tpu_torch.models.trainer import (
    TrainedRanker, TrainerConfig, make_trainer_solver, run_generators,
    start_params, train_step,
)

log = logging.getLogger(__name__)


def train_ranker_streaming(model: RankModel, sample: TrainSample,
                           cfg: Optional[TrainerConfig] = None,
                           chunk_rows: int = 1 << 20, *,
                           device: str | torch.device = "cuda"
                           ) -> TrainedRanker:
    """Same contract as train_ranker (without resume); `chunk_rows`
    (rounded down to a multiple of the batch size) bounds what the
    device holds: two chunk buffers of chunk_rows × (width + 2) float32."""
    cfg = cfg or TrainerConfig()
    dev = resolve_device(device)
    n, width = sample.x.shape
    bs = min(cfg.batch_size, n)
    chunk_rows = max(bs, (chunk_rows // bs) * bs)
    n_chunks = -(-n // chunk_rows)
    n_b = chunk_rows // bs

    solver = make_trainer_solver(cfg)
    params, opt_state = start_params(model, cfg, solver, None, dev)
    shuffle_gen, drop_gen = run_generators(cfg, 0, dev)
    info = sample.info
    y_all = np.asarray(sample.y, dtype=np.float32).ravel()

    cuda = dev.type == "cuda"
    host = [torch.zeros((chunk_rows, width + 2), dtype=torch.float32,
                        pin_memory=cuda) for _ in range(2)]
    bufs = [torch.empty((chunk_rows, width + 2), dtype=torch.float32,
                        device=dev) for _ in range(2)]
    copy_stream = torch.cuda.Stream(dev) if cuda else None
    copied = [None, None]

    def put(ci: int, slot: int) -> None:
        """Chunk ci, zero-padded, into bufs[slot] (on the side stream)."""
        if copied[slot] is not None:
            copied[slot].synchronize()      # host[slot]'s last copy is done
        s, e = ci * chunk_rows, min((ci + 1) * chunk_rows, n)
        h = host[slot]
        h.zero_()
        h[:e - s, :width] = torch.from_numpy(
            np.ascontiguousarray(sample.x[s:e], dtype=np.float32))
        h[:e - s, width] = torch.from_numpy(y_all[s:e])
        h[:e - s, width + 1] = 1.0
        if not cuda:
            bufs[slot].copy_(h)
            return
        # the buffer's previous chunk trained on the current stream
        copy_stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(copy_stream):
            bufs[slot].copy_(h, non_blocking=True)
            copied[slot] = torch.cuda.Event()
            copied[slot].record(copy_stream)

    rng = np.random.default_rng(cfg.seed)
    best = float("inf")
    no_improve = 0
    loss_curve: list[float] = []
    epoch_times: list[float] = []
    for epoch in range(cfg.epochs):
        te = time.perf_counter()
        order = (rng.permutation(n_chunks) if cfg.shuffle
                 else np.arange(n_chunks))
        put(order[0], 0)
        chunk_losses = []
        for i, ci in enumerate(order):
            slot = i % 2
            if i + 1 < len(order):
                put(order[i + 1], 1 - slot)  # overlaps this chunk's steps
            if cuda:
                torch.cuda.current_stream(dev).wait_event(copied[slot])
            buf = bufs[slot]
            perm = (torch.randperm(chunk_rows, generator=shuffle_gen,
                                   device=dev) if cfg.shuffle else None)
            losses = []
            for b in range(n_b):
                rows = (buf[b * bs:(b + 1) * bs] if perm is None
                        else buf[perm[b * bs:(b + 1) * bs]])
                loss, opt_state = train_step(
                    model, params, solver, opt_state, rows[:, :width],
                    rows[:, width], rows[:, width + 1], info, drop_gen)
                losses.append(loss)
            chunk_losses.append(torch.stack(losses).mean())
        cost = float(torch.stack(chunk_losses).double().mean())
        epoch_times.append(time.perf_counter() - te)
        loss_curve.append(cost)
        if cost < best - cfg.tol:
            best, no_improve = cost, 0
        else:
            no_improve += 1
        if cfg.verbose:
            log.info("epoch %d | cost %.6f | %.2fs", epoch, cost,
                     epoch_times[-1])
        if cfg.early_stop and no_improve >= cfg.early_stop:
            break
    if cuda:
        torch.cuda.current_stream(dev).wait_stream(copy_stream)
    for p in param_leaves(params):
        p.requires_grad_(False)
    return TrainedRanker(
        model=model, params=params, info=info,
        behavior_len=model.behavior_len, loss_curve=loss_curve,
        epoch_times=epoch_times, opt_state=opt_state)
