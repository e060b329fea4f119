#!/usr/bin/env python3
"""Drive goctr_tpu_torch on one NVIDIA card and check it end to end.

    python3 chip_smoke.py            (from the repository root)

Phases, in order; any failure raises and the script exits nonzero:
  1. build   — compile every CUDA kernel of the port from
               goctr_tpu_torch/csrc/ (one nvcc per source, in parallel);
               print the card's name and power limit.
  2. kernels — each kernel against its plain PyTorch version on the card,
               at the shapes the serving path gives it (K1 on the plain and
               packed layouts with out-of-range ids; K2 at the headline
               shape in bf16 and f32, at T = 512 with ragged histories,
               at T = 500 and at D = 16), with times.
  3. serve   — the headline SparseCTR (10M × 64 item table, DIN pool,
               1024-512-256 bf16 tower; weights from a seed) serving
               32 requests × 400 candidates per score_batch, from the plain
               [V, 64] table and the packed [V, 128] table. Launch counts
               are reset just before and read just after; scores are held
               against a plain-PyTorch reference on the card, controls
               (wrong rows, a zeroed pool) show that the limit would catch
               a wrong kernel, and a small f32 model is held against the
               port on the CPU.
  4. grouped — the 100M × 16 configuration on grouped 128-lane lines
               (G = 7, 7.3 GB): K1 and K2 against their plain versions
               on this path's own inputs, then driven and checked the
               same way.
  5. http    — RecApiServer on a free port answers concurrent
               POST /api/v1/recommend through the MicroBatcher.
  6. train   — the headline trained by the port's scanned trainer at full
               width (10M × 64, batch 65,536, adam + table adagrad, the
               JAX bench's compact_cap rule) on 16 × 65,536 rows of the
               JAX bench workload (planted parity, zipf s = 1.05, noisy
               labels). The main path, launch counts reset just before
               and read just after: 3 epochs of update_mode "fused" with
               compact_impl="xla" and the split row update, then one
               epoch from the same start for each other update path —
               kernel compaction (K9), the one-pass row update (K5),
               "fused2" (K7), "runfused" (K8) and "dedup" — whose
               first-epoch losses must agree with the first, and one
               epoch each of "plain" and "sorted" (per-occurrence
               adagrad), which must be finite and agree with each other.
               K1 (the forward gather and the row update's read), K2,
               K2b, K4, K5, K9, K7 and K8 are held against their plain
               versions on the first step's own inputs (K7 and K8 to a
               limit derived from the exact update of each line), with
               controls that must exceed each limit, and timed beside
               their plain versions (K7 and K8 also beside the fused
               path's update of the same stream); wrong compactions and
               K7 / K8 fed a wrong stream (controls) move the first-epoch
               loss past its limit; small f32 models trained on the card
               in every update mode are held against the port on the
               CPU; a profiled step gives the device-time breakdown; the
               trained result serves through DeviceScorer with the
               phase-3 score check and controls.
  7. grouped training — the 100M × 16 configuration (G = 7 rows per
               128-lane line, 7.3 GB of lines drawn directly) trained at
               batch 65,536 on the JAX bench's 1,000,000-row workload for
               this configuration: 3 epochs with the split line update
               (K1 read, torch, K4) and 1 epoch from the same start with
               the one-pass kernels (K6, K9) — the main path, counts reset
               just before and read just after. K1, K2, K2b, K9, K4 and K6
               are held against their plain versions on the first step's
               own inputs, with controls; the first-epoch losses agree,
               and K6 writing each update to its neighbour slot's line
               (control) moves that loss past the limit; small grouped
               f32 trainers on the card (grouped lines, and the other
               update modes from lines) are held against the port on the
               CPU; 3 profiled steps; the trained lines serve with the
               score check and controls.
  8. mesh    — the mesh trainer train_sparse on the 1×1 mesh. K3 (fused
               gather + pool) against its plain version on the dense
               path's first batch (B = 65,536, T = 32, D = 64, mean and
               sum) and at odd shapes, its gradient against autograd
               through the plain pool, controls, and times beside
               embedding_bag. The main path, counts reset just before and
               read just after: the dense path (the table trained by adam
               with the tower) at the headline widths with mean pooling,
               TRAIN_EPOCHS shuffled epochs; the trained ranker's predict
               on held-out rows (K3), held against the plain path with
               controls; a profiled dense step. The sparse path (headline
               DIN, table adagrad, fused): one epoch each with the split
               update and K5 against one scanned epoch from the same
               start, a control (each run written to the next id's line);
               one epoch of the 100M × 16 grouped-resident lines through
               the mesh step (K6); small f32 mesh trainers card vs CPU.
Then it prints the card line, the `kernels` JSON line (ten kernels)
and, last, {"ok": true, "device": {...}}.

Exits nonzero when no CUDA device is available.
"""
from __future__ import annotations

import functools
import json
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

SEED = 0
R_REQ, K_CAND = 32, 400            # requests × candidates per score_batch
TIMED_BATCHES = 32
HEADLINE = dict(item_vocab=10_000_000, emb_dim=64, u_profile_dim=48,
                ctx_dim=16, behavior_len=32, hidden=(1024, 512, 256),
                activation="relu")
GROUPED = dict(HEADLINE, item_vocab=100_000_000, emb_dim=16)
# NVIDIA H100 SXM data sheet: HBM3 rate, f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# kernel vs plain tolerances (|got - want| <= ATOL + RTOL·|want|):
#  f32: both sum in f32, in different orders (warp-shuffle trees vs
#       torch reductions) — a few f32 ulps;
#  bf16 output: both round an f32 value that agrees to a few f32 ulps,
#       so the outputs agree to one bf16 ulp (at most 2^-7 relative).
TOL = {"float32": (1e-6, 1e-5), "bfloat16": (1e-6, 8e-3)}
# scores (probabilities) through the kernels vs the plain path at bf16:
# pooled rows differ by at most one bf16 ulp, and f32 accumulation-order
# differences can flip the bf16 rounding of a hidden activation; on an
# H100 that reads up to 2.2e-5 (PERF.md). The table is N(0, 0.01²), so
# even a wrong row moves a score by only ~1e-4..1e-3: check_controls()
# shows in every run that wrong rows and a zeroed pool exceed this limit
SCORE_ATOL_BF16 = 1e-4
# the small f32 model on the card vs the port on the CPU: f32 sums in
# other orders (cuBLAS vs the CPU BLAS), TF32 off
SCORE_ATOL_F32 = 1e-5
# the trained headline's scores, kernels vs plain path: the same one-ulp
# pooled-row differences as SCORE_ATOL_BF16, but trained rows and weights
# are larger, so a flipped bf16 rounding moves a score further (8.4e-5 on
# an H100, PERF.md); its controls read 3.7e-3 and more. The trained
# 100M x 16 lines are held to it too (the same one-ulp differences at
# D = 16).
SCORE_ATOL_TRAINED = 3e-4
# training phase: the JAX bench's depth except rows (bench.py:139-160)
TRAIN_BATCH = 65_536
TRAIN_ROWS = 16 * TRAIN_BATCH
TRAIN_EPOCHS = 3
TABLE_LR = 2.0
# grouped training: the JAX bench's rows for 100M x 16 (bench.py:146-147)
GROUPED_TRAIN_ROWS = 1_000_000
# K2b vs its plain version (bf16 d_behaviors / d_item): both round an f32
# value that agrees to a few f32 ulps, so one bf16 ulp (rtol 2^-7); where
# the three terms of a gradient cancel, the f32 values themselves differ
# by f32 rounding of the terms, so an atol of 1e-6 of the largest
# gradient. d_att0 sums 65,536 rows in another order (fixed partials vs
# torch.sum) with cancellation between rows: rtol 1e-3 plus 1e-4 of the
# largest entry.
GRAD_RTOL_BF16 = 2.0 ** -7
GRAD_ATOL_REL = 1e-6
ATT0_RTOL, ATT0_ATOL_REL = 1e-3, 1e-4
# K9 vs its plain version: the same f32 rows summed in another order
# (tiles + carries vs index_add_), so each run sum lies within 1e-5 of the
# run's sum of |g| (~168 f32 ulps of it: runs reach ~10^5 rows)
RUNSUM_RTOL = 1e-5
# xla vs kernel compaction, first-epoch mean loss: the run sums differ by
# f32 rounding, which flips a few bf16 roundings of the tower in later
# steps of the epoch (2.59e-7 relative on an H100, PERF.md; the path is
# deterministic); compaction_controls() shows in every run that a wrong
# compaction moves it past this limit
LOSS_RTOL_IMPL = 1e-5
# plain vs sorted, first-epoch mean loss: both add every occurrence's
# ‖g‖² into the accumulator and its scaled gradient into the table, the
# one in batch order, the other after a stable sort; scatter_add_rows adds
# each id's rows in the order they come (a stable sort and one pass per
# id on the card), which is batch order in both, and this workload has no
# behavior pads (which plain adds to row 0 as zeros): the same f32 adds
# in the same order, so the losses agree bit for bit. (With index_add_'s
# atomics they read 2.99e-5 apart on an H100, PERF.md.)
LOSS_RTOL_PAIR = 0.0
# small f32 trainer, card vs CPU (the JAX package's own trainer parity
# tolerances): loss curves rtol 1e-5, tables rtol 1e-4 / atol 1e-5
TRAJ_LOSS_RTOL = 1e-5
TRAJ_TABLE_RTOL, TRAJ_TABLE_ATOL = 1e-4, 1e-5
# K3's gradient (index_add_: f32 atomics that add a hot id's ~10^4-10^5
# terms in any order) against autograd through the plain pool in f64:
# each entry within 1e-4 of the sum of its terms' magnitudes, + 1e-7
POOL_GRAD_REL = 1e-4
# the mesh trainer's sparse path vs one train_sparse_scanned epoch,
# first-epoch loss: the JAX package holds its mesh step to the scanned
# step's math within rtol 2e-5 (tests/test_sparse_trainer.py:158); the
# mesh step sums each id's rows through one more cumsum difference (stage
# 3), so its updates differ in f32 rounding
MESH_LOSS_RTOL = 2e-5
# mesh predict: held-out rows and the trainer's predict batch
MESH_PREDICT_BATCH = 8192
MESH_PREDICT_ROWS = 4 * MESH_PREDICT_BATCH


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def _zipf_ranks(rng, shape, n_ranks, s=1.05):
    """Bounded-zipf rank draws in [0, n_ranks): P(r) ≈ (r+1)^-s, by the
    closed-form inverse CDF of the continuous bounded power law (the
    request popularity law of the JAX package's bench)."""
    u = rng.random(shape)
    t = float(n_ranks) ** (1.0 - s)
    x = (1.0 - u * (1.0 - t)) ** (1.0 / (1.0 - s))
    return np.minimum(x.astype(np.int64) - 1, n_ranks - 1).clip(0)


def make_requests(rng, n, vocab, cfg):
    """n requests: zipf-popular ids with hot ranks scattered over the id
    space (Knuth multiplicative hash, as the bench workload does), ragged
    behavior histories (-1 padded), K_CAND candidates each."""
    half = vocab // 2
    prime = 2_654_435_761

    def draw(shape):
        r = _zipf_ranks(rng, shape, half)
        return ((r * prime) % half * 2 + rng.integers(0, 2, shape)
                ).astype(np.int32)

    t = cfg["behavior_len"]
    bids = draw((n, t))
    lens = rng.integers(t // 4, t + 1, n)
    bids[np.arange(t)[None, :] >= lens[:, None]] = -1
    return {"prof": rng.random((n, cfg["u_profile_dim"]), dtype=np.float32),
            "bids": bids,
            "ctx": rng.random((n, cfg["ctx_dim"]), dtype=np.float32),
            "cands": [draw((K_CAND,)) for _ in range(n)]}


def batch(reqs, i):
    s = slice(i * R_REQ, (i + 1) * R_REQ)
    return reqs["prof"][s], reqs["bids"][s], reqs["ctx"][s], reqs["cands"][s]


def cuda_ms(torch, fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(torch, got, want, dtype_name: str, what: str) -> float:
    """Max |got - want| over non-NaN entries; NaN positions must match
    and every entry must be inside the stated tolerance."""
    g, w = got.float(), want.float()
    require(torch.equal(torch.isnan(g), torch.isnan(w)),
            f"{what}: NaN rows differ")
    ok = ~torch.isnan(w)
    diff = (g[ok] - w[ok]).abs()
    atol, rtol = TOL[dtype_name]
    bad = int((diff > atol + rtol * w[ok].abs()).sum())
    err = float(diff.max()) if diff.numel() else 0.0
    require(bad == 0, f"{what}: {bad} entries outside atol={atol} "
                      f"rtol={rtol} (max err {err:.3g})")
    return err


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------- phase 2 --
def check_gather(torch, kern, table, ids, group, dim, vocab_rows, what):
    """K1 vs its plain version on `ids` and on out-of-range ids; bit-exact
    (a copy and a round-to-nearest-even cast) in f32 and bf16."""
    bad_ids = torch.tensor([-7, -1, vocab_rows, vocab_rows + 5, 2**31 - 1,
                            0, vocab_rows - 1], dtype=torch.int32,
                           device=table.device)
    errs = []
    for out_dtype in (torch.bfloat16, torch.float32):
        for x in (ids, bad_ids):
            got = kern.gather_rows(table, x, group=group, dim=dim,
                                   out_dtype=out_dtype)
            want = kern.gather_rows_plain(table, x, group=group, dim=dim,
                                          out_dtype=out_dtype)
            torch.cuda.synchronize()
            require(torch.equal(torch.isnan(got), torch.isnan(want))
                    and torch.equal(torch.nan_to_num(got),
                                    torch.nan_to_num(want)),
                    f"K1 {what} {out_dtype}: differs from plain")
            if x is bad_ids:
                require(bool(torch.isnan(got[:5]).all())
                        and not bool(torch.isnan(got[5:]).any()),
                        f"K1 {what}: out-of-range ids must give NaN rows")
            errs.append(max_err(torch, got, want, "float32", f"K1 {what}"))
    log(f"[kernels] K1 {what}: n={ids.numel()} bit-exact vs plain "
        f"(f32 and bf16 out; out-of-range ids give NaN)")
    return max(errs)


def check_din(torch, kern, beh, item, att0, mask, what):
    got = kern.din_attention_pool(beh, item, att0, mask)
    want = kern.din_attention_pool_plain(beh, item, att0, mask)
    torch.cuda.synchronize()
    name = str(beh.dtype).split(".")[-1]
    err = max_err(torch, got, want, name, f"K2 {what}")
    atol, rtol = TOL[name]
    log(f"[kernels] K2 {what}: B,T,D={tuple(beh.shape)} {name} max_abs_err="
        f"{err:.3g} (tol atol={atol} rtol={rtol})")
    return err


def path_inputs(torch, scorer, bids, cands, k):
    """What one score_batch of these requests hands the kernels, built as
    DeviceScorer._forward builds it: the ids K1 gathers (behaviors, then
    candidates padded with -1 to the k bucket, clamped at 0), and K2's
    inputs from the gathered rows (behavior rows and mask broadcast to
    every candidate)."""
    R, T = bids.shape
    D = scorer.model.emb_dim
    iids = np.full((R, k), -1, np.int32)
    for r, c in enumerate(cands):
        iids[r, :len(c)] = c
    ids = torch.from_numpy(np.concatenate(
        [bids.reshape(-1), iids.reshape(-1)]).clip(0)).to(scorer.device)
    rows = scorer.rows_of(ids)
    eb = rows[:R * T].reshape(R, T, D)[:, None].expand(
        R, k, T, D).reshape(R * k, T, D)
    mask = torch.from_numpy((bids >= 0).astype(np.float32)).to(
        scorer.device)[:, None].expand(R, k, T).reshape(R * k, T)
    return ids, eb, rows[R * T:], mask


def din_inputs(torch, rng, b, t, d, dtype, dev, lengths=False):
    """Random K2 inputs with a zero behavior row and an all-masked row;
    the mask is random, or with lengths=True a ragged history per row
    (the first len_b of T positions), as the serving path gives it."""
    beh = torch.from_numpy(rng.normal(0, 1, (b, t, d)).astype(np.float32))
    beh[0, 3] = 0.0                                # a zero behavior row
    if lengths:
        lens = rng.integers(1, t + 1, (b, 1))
        mask = torch.from_numpy((np.arange(t)[None, :] < lens)
                                .astype(np.float32))
    else:
        mask = torch.from_numpy((rng.random((b, t)) > 0.3)
                                .astype(np.float32))
    mask[1] = 0.0                                  # an all-masked row
    item = torch.from_numpy(rng.normal(0, 1, (b, d)).astype(np.float32))
    att0 = torch.from_numpy(rng.normal(1, 0.3, t).astype(np.float32))
    return (beh.to(dev, dtype), item.to(dev, dtype), att0.to(dev),
            mask.to(dev))


# ------------------------------------------------------------- phase 3 --
def plain_scores(torch, scorer, prof, bids, ctx, cands):
    """Scores of one batch through the plain versions of K1 and K2 on the
    card (same bucket padding as the scorer, same tower)."""
    from goctr_tpu_torch.ops.kernels.din_attention import (
        din_attention_pool_plain)
    from goctr_tpu_torch.ops.kernels.row_gather import gather_rows_plain

    model, dev = scorer.model, scorer.device
    R, T, D = len(cands), bids.shape[1], model.emb_dim
    K = min(b for b in scorer.cand_buckets if b >= K_CAND)
    iids = np.full((R, K), -1, np.int32)
    for r, c in enumerate(cands):
        iids[r, :len(c)] = c

    def rows(ids):
        return gather_rows_plain(scorer.table, ids.clamp_min(0),
                                 group=scorer.packed_group, dim=D,
                                 out_dtype=model.compute_dtype)

    b_t = torch.from_numpy(bids).to(dev)
    i_t = torch.from_numpy(iids).to(dev)
    eb = rows(b_t)[:, None].expand(R, K, T, D).reshape(R * K, T, D)
    mk = (b_t >= 0).float()[:, None].expand(R, K, T).reshape(R * K, T)
    item = rows(i_t).reshape(R * K, D)
    pr = torch.from_numpy(prof).to(dev).repeat_interleave(K, 0)
    cx = torch.from_numpy(ctx).to(dev).repeat_interleave(K, 0)
    pooled = din_attention_pool_plain(eb, item, model.att0, mk)
    scores = torch.sigmoid(model._tower(pr, pooled, item, cx)).reshape(R, K)
    scores = scores.cpu().numpy()
    return [scores[r, :len(c)] for r, c in enumerate(cands)]


def drive(torch, kernels, scorer, reqs, what):
    """Reset the launch counts, serve 2 + TIMED_BATCHES batches (two to
    warm up), read the counts; return (outputs of batch 0, scores/s over
    the timed batches, launches)."""
    gather, din = kernels
    gather.launches = 0
    din.launches = 0
    first = scorer.score_batch(*batch(reqs, 0))
    scorer.score_batch(*batch(reqs, 1))                  # warm-up
    n, lat = 0, []
    for i in range(1, TIMED_BATCHES + 1):
        t0 = time.perf_counter()
        n += sum(len(o) for o in scorer.score_batch(*batch(reqs, i)))
        lat.append(time.perf_counter() - t0)
    dt = sum(lat)
    launches = {"row_gather": gather.launches,
                "din_attention": din.launches}
    require(all(v > 0 for v in launches.values()),
            f"{what}: a kernel of the path was never launched {launches}")
    rate = n / dt
    log(f"[serve] {what}: {TIMED_BATCHES} batches of {R_REQ}x{K_CAND}, "
        f"{rate:.1f} scores/s; batch latency median "
        f"{np.median(lat) * 1e3:.3f} ms, max {max(lat) * 1e3:.3f} ms; "
        f"launches {launches}")
    return first, rate, launches


def check_scores(outs, want, atol, what):
    err = 0.0
    for o, w in zip(outs, want):
        require(o.shape == w.shape and np.isfinite(o).all()
                and ((o >= 0) & (o <= 1)).all(),
                f"{what}: scores not finite probabilities of the right shape")
        err = max(err, float(np.abs(o - w).max()))
    require(err <= atol, f"{what}: max |diff| {err:.3g} > {atol}")
    log(f"[serve] {what}: max |score diff| {err:.3g} (tol {atol})")
    return err


def check_controls(torch, scorer, got, prof, bids, ctx, cands, what,
                   limit=SCORE_ATOL_BF16):
    """Wrong inputs through the plain path must move some score of `got`
    by more than `limit`, or the score check could not catch a wrong
    kernel: behavior rows shifted by one id (a wrong K1 row), no
    behaviors (every gate 0: K2's output zeroed), candidate rows shifted
    by one id. Returns the readings."""
    V = scorer.model.item_vocab
    controls = {
        "behavior rows shifted": (
            np.where(bids >= 0, (bids + 1) % V, -1).astype(np.int32), cands),
        "pool zeroed": (np.full_like(bids, -1), cands),
        "candidate rows shifted": (
            bids, [((c + 1) % V).astype(np.int32) for c in cands]),
    }
    readings = {}
    for name, (b, c) in controls.items():
        want = plain_scores(torch, scorer, prof, b, ctx, c)
        readings[name] = max(float(np.abs(o - w).max())
                             for o, w in zip(got, want))
        require(readings[name] > limit,
                f"{what} control '{name}': max |score diff| "
                f"{readings[name]:.3g} is inside the limit "
                f"{limit}, which therefore cannot catch it")
    log(f"[serve] {what} controls (must exceed {limit}): "
        + ", ".join(f"{k} {v:.3g}" for k, v in readings.items()))
    return readings


def _device_events(prof):
    """(self device us, count, name) of every kernel and copy profiled."""
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue                    # host ops: their kernels are listed
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.count, e.key))
    return sorted(rows, reverse=True)


def kernel_name(key: str) -> str:
    """A profiler key's function name (`ns::name<...>(args)` → name)."""
    m = re.search(r"::(\w+)", key)
    return m[1] if m else key[:40]


def device_ms(torch, fn, n_inputs, iters=24, by_kernel=None) -> float:
    """Device time of one call of fn(i): every kernel and copy that
    `iters` calls (cycling over n_inputs input sets) ran, summed by
    torch.profiler, over iters. Host launch gaps are not counted. A list
    given as `by_kernel` receives (ms per call, name) of each kernel."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(n_inputs):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i % n_inputs)
        torch.cuda.synchronize()
    rows = _device_events(prof)
    if by_kernel is not None:
        by_kernel.extend((us / iters / 1e3, key) for us, _, key in rows)
    return sum(r[0] for r in rows) / iters / 1e3


def profile_batch(torch, scorer, reqs):
    """Device time by kernel, and host time by op, over two score_batch
    calls (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    scorer.score_batch(*batch(reqs, 1))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in (1, 2):
            scorer.score_batch(*batch(reqs, i))
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_events(prof)
    busy = sum(r[0] for r in rows)
    log(f"[profile] 2 headline batches: wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy / 1e3:.3f} ms (idle share "
        f"{max(0.0, 1 - busy / wall_us):.3f})")
    for us, count, key in rows[:14]:
        log(f"[profile]   device {us / 2e3:9.4f} ms/batch  x{count // 2:<3d} "
            f"{key[:90]}")
    host = sorted(((e.self_cpu_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if "CUDA" not in str(getattr(e, "device_type", ""))),
                  reverse=True)
    for us, count, key in host[:10]:
        log(f"[profile]   host   {us / 2e3:9.4f} ms/batch  x{count // 2:<3d} "
            f"{key[:90]}")


def small_f32_check(torch, dev):
    """A small f32 model: the port on the card (kernels) vs the port on the
    CPU (plain versions), all three layouts."""
    from goctr_tpu_torch.ops.kernels.row_optimizer import (
        group_size, pack_table, pack_table_grouped)
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
    from goctr_tpu_torch.serve.scorer import DeviceScorer

    cfg = dict(item_vocab=5000, emb_dim=16, u_profile_dim=8, ctx_dim=4,
               behavior_len=10, hidden=(64, 32), activation="relu")
    gen = torch.Generator().manual_seed(SEED)
    m_cpu = SparseCTR(**cfg, device="cpu")
    table = m_cpu.init_params(gen)
    m_gpu = SparseCTR(**cfg, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    rng = np.random.default_rng(SEED + 1)
    prof = rng.random((5, 8), dtype=np.float32)
    bids = rng.integers(-1, 5000, (5, 10)).astype(np.int32)
    ctx = rng.random((5, 4), dtype=np.float32)
    cands = [rng.integers(0, 5005, k).astype(np.int32)
             for k in (3, 130, 400, 700, 2100)]      # ids past V: 0 or NaN
    err = 0.0
    for layout, t, kw in (
            ("plain", table, {}),
            ("packed", pack_table(table), {"table_packed": True}),
            ("grouped", pack_table_grouped(table),
             {"packed_group": group_size(16)})):
        want = DeviceScorer(m_cpu, t, device="cpu", **kw).score_batch(
            prof, bids, ctx, cands)
        got = DeviceScorer(m_gpu, t, device=dev, **kw).score_batch(
            prof, bids, ctx, cands)
        for g, w in zip(got, want):
            require(np.array_equal(np.isnan(g), np.isnan(w)),
                    f"small f32 {layout}: NaN scores differ")
            ok = ~np.isnan(w)
            err = max(err, float(np.abs(g[ok] - w[ok]).max()))
    require(err <= SCORE_ATOL_F32,
            f"small f32 model: card vs CPU max diff {err:.3g}")
    log(f"[serve] small f32 model, 3 layouts, card (kernels) vs CPU "
        f"(plain): max |score diff| {err:.3g} (tol {SCORE_ATOL_F32})")


# ------------------------------------------------------------- phase 5 --
def http_check(scorer, reqs):
    from goctr_tpu_torch.serve.api import RecApiServer
    from goctr_tpu_torch.serve.scorer import MicroBatcher, SparseRankPredictor

    n_users = 16
    pred = SparseRankPredictor(
        scorer=scorer, user_profiles=reqs["prof"][:n_users],
        user_behaviors=reqs["bids"][:n_users], default_ctx=reqs["ctx"][0],
        batcher=MicroBatcher(scorer, max_requests=8, max_wait_s=0.02))
    srv = RecApiServer(pred, host="127.0.0.1", port=0).start(background=True)
    url = f"http://127.0.0.1:{srv.port}"
    results: dict[int, object] = {}

    def post(uid):
        body = json.dumps({"userId": uid, "itemIdList":
                           [int(i) for i in reqs["cands"][uid]]}).encode()
        req = urllib.request.Request(f"{url}/api/v1/recommend", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as resp:
            results[uid] = (resp.status, json.loads(resp.read()),
                            time.perf_counter() - t0)

    try:
        post(0)                         # warm the server's first request
        results.clear()
        threads = [threading.Thread(target=post, args=(u,))
                   for u in range(n_users)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        dt = time.perf_counter() - t0
        require(not any(t.is_alive() for t in threads),
                "http: a request did not finish")
        require(len(results) == n_users, "http: a request failed")
        err = 0.0
        for uid, (status, out, _) in results.items():
            require(status == 200, f"http: status {status}")
            lst = out["itemScoreList"]
            require([e["itemId"] for e in lst]
                    == [int(i) for i in reqs["cands"][uid]],
                    "http: item ids out of order")
            want = scorer.score(reqs["prof"][uid], reqs["bids"][uid],
                                reqs["ctx"][0], reqs["cands"][uid])
            err = max(err, float(np.abs(
                np.array([e["score"] for e in lst]) - want).max()))
        require(err <= SCORE_ATOL_BF16, f"http: scores differ by {err:.3g}")
        with urllib.request.urlopen(f"{url}/service/overview",
                                    timeout=30) as resp:
            require(resp.status == 200, "http: /service/overview")
        try:
            urllib.request.urlopen(urllib.request.Request(
                f"{url}/api/v1/recommend", data=json.dumps(
                    {"userId": 1, "itemIdList": []}).encode()), timeout=30)
            require(False, "http: an empty itemIdList must give 400")
        except urllib.error.HTTPError as e:
            require(e.code == 400, f"http: empty list gave {e.code}")
    finally:
        srv.stop()
    lat = sorted(r[2] for r in results.values())
    log(f"[http] {n_users} concurrent POST /api/v1/recommend x {K_CAND} "
        f"candidates in {dt * 1e3:.1f} ms (request latency median "
        f"{np.median(lat) * 1e3:.1f} ms, max {lat[-1] * 1e3:.1f} ms); "
        f"scores match the scorer (max diff {err:.3g})")


# ------------------------------------------------------------- phase 6 --
@functools.lru_cache(maxsize=None)
def make_workload(n, vocab, t, u, c, seed=0):
    """The JAX package's bench workload (bench.py:44-109, copied: bench.py
    imports the JAX package), with its defaults zipf=True, noisy=True;
    made once per argument set (the phases only read it).
    Planted parity: label = item parity == the user's taste parity, which
    85% of the behaviors carry; zipf (s = 1.05) popularity with hot ranks
    scattered over the id space by a multiplicative hash; 15% of labels
    flip and hot items lean positive."""
    from goctr_tpu_torch.parallel.sparse_trainer import SparseSample

    rng = np.random.default_rng(seed)
    uids = rng.integers(0, max(n // 256, 1), n).astype(np.int32)
    user_taste = rng.integers(0, 2, max(n // 256, 1))
    taste = user_taste[uids]
    half = vocab // 2
    prime = 2_654_435_761            # Knuth multiplicative hash, odd

    def draw(shape):
        r = _zipf_ranks(rng, shape, half)
        return (r * prime) % half, r

    b_slot, _ = draw((n, t))
    b_alt, _ = draw((n, t))
    bids = np.where(
        rng.random((n, t)) < 0.85,
        b_slot * 2 + taste[:, None],
        b_alt * 2 + rng.integers(0, 2, (n, t))).astype(np.int32)
    i_slot, i_rank = draw((n,))
    iids = (i_slot * 2 + rng.integers(0, 2, n)).astype(np.int32)
    parity = ((iids % 2) == taste)
    hot = i_rank < max(half // 10, 1)
    p_pos = np.where(parity, 0.85, 0.15) + np.where(hot, 0.10, -0.01)
    y = (rng.random(n) < p_pos.clip(0.02, 0.98)).astype(np.float32)
    return SparseSample(
        user_profile=rng.random((n, u), dtype=np.float32),
        behavior_ids=bids, item_ids=iids,
        ctx=rng.random((n, c), dtype=np.float32), labels=y)


def bench_compact_cap(sample, bs: int) -> int:
    """bench.py's rule: the first batch's unique ids + 15%, rounded up to
    a multiple of 1024."""
    b0 = np.concatenate([sample.behavior_ids[:bs].ravel(),
                         sample.item_ids[:bs]])
    uniq0 = len(np.unique(b0[b0 >= 0]))
    return -(-int(uniq0 * 1.15) // 1024) * 1024


def within(torch, got, want, rtol, atol):
    """(entries outside |got − want| <= atol + rtol·|want|, max error)."""
    diff = (got.float() - want.float()).abs()
    bad = int((diff > atol + rtol * want.float().abs()).sum())
    return bad, float(diff.max()) if diff.numel() else 0.0


def first_step(torch, start, sample, cfg, topt, dev):
    """What each kernel of the training path gets in the main path's first
    step, rebuilt with the trainer's own functions from the same start:
    the batch of the first epoch's first indices (padded rows as the
    trainer pads them), K1's ids and the rows it gathered, K2's output and
    K2b's inputs (the gathered rows, att0, mask and the tower's gradient
    of the pooled rows), K9's sorted stream, and the row update's inputs:
    a copy of the packed table ([V, 128] rows, or grouped lines), its
    targets (slots at G = 1, lines below), the update rows K5 / K6 take
    and the new lines the split update writes with K4."""
    import copy

    from goctr_tpu_torch.ops.kernels.din_attention import din_attention_pool
    from goctr_tpu_torch.ops.kernels.row_optimizer import (
        group_size, pack_grads, pack_table, updated_lines)
    from goctr_tpu_torch.parallel import scanned as sc

    V, D = start.model.item_vocab, start.model.emb_dim
    G = group_size(D)
    n, bs = sample.rows, cfg.batch_size
    gen = sc.trainer_generator(cfg, 0, dev)
    idx = sc.epoch_order(gen, -(-n // bs) * bs, cfg.shuffle, dev)[:bs]
    idx = idx.cpu().numpy()
    real = idx < n

    def col(a, fill=0):
        out = np.full((bs,) + a.shape[1:], fill, a.dtype)
        out[real] = a[idx[real]]
        return torch.from_numpy(out).to(dev)

    prof, bids, iids = col(sample.user_profile), \
        col(sample.behavior_ids, -1), col(sample.item_ids)
    ctx, y = col(sample.ctx), col(np.asarray(sample.labels, np.float32))
    w = torch.from_numpy(real.astype(np.float32)).to(dev)
    model = copy.deepcopy(start.model)
    table = (start.table.clone() if start.packed_group > 1
             else pack_table(start.table, torch.zeros(V, device=dev)))
    T = bids.shape[1]
    with torch.enable_grad():
        emb = sc.gather_batch_rows(model, table, bids, iids, False,
                                   G).requires_grad_()
        beh = emb.detach()[:bs * T].view(bs, T, D)
        item = emb.detach()[bs * T:]
        mask = (bids >= 0).float()
        att0 = model.att0.detach()
        pooled = din_attention_pool(beh, item, att0, mask).requires_grad_()
        logits = model._tower(prof, pooled, item, ctx, train=True)
        dout = torch.autograd.grad(sc.bce_loss(logits, y, w), pooled)[0]
        loss = sc.batch_loss(model, emb, prof, bids, ctx, y, w)
        g_emb = torch.autograd.grad(loss, emb)[0]
    ids_flat = torch.cat([bids.reshape(-1), iids])
    g_flat = g_emb.float()
    s_ids, g_s = sc.sort_updates(ids_flat, g_flat, V)
    capr = sc.compact_slots(topt.compact_cap, s_ids.shape[0])
    tgt, rows, packed, _ = sc.update_rows(ids_flat, g_flat, topt, V)
    if G > 1:
        tgt, upd = sc.line_stream(tgt, rows, V)
    else:
        upd = packed if packed is not None else pack_grads(rows)
    skip = table.shape[0] if G > 1 else V
    new = updated_lines(table, tgt, upd, topt.lr, D, topt.kind, topt.eps, G)
    return {"pool": (dout.contiguous(), beh, item, att0, mask),
            "gather_ids": ids_flat.clamp_min(0), "emb": emb.detach(),
            "pooled": pooled.detach(),
            "s_ids": s_ids, "g_s": g_s, "capr": capr, "table": table,
            "tgt": tgt, "upd": upd, "new": new, "skip": skip, "group": G,
            "topt": topt, "V": V, "D": D}


def check_train_gather(torch, step):
    """K1 against its plain version at both of the training path's calls
    on the first step's inputs, bit-exact, each with a control (ids
    shifted by one) that must change some row: the forward gather of the
    batch's ids to bf16 (the rows the trainer took, `emb`; group G on
    grouped lines), and the split update's f32 read of all 128 lanes of
    its targets (`updated_lines`). Returns (max error, controls)."""
    from goctr_tpu_torch.ops.kernels import row_gather as k1
    from goctr_tpu_torch.ops.kernels.row_optimizer import LANES

    V, D, G, table = step["V"], step["D"], step["group"], step["table"]
    n_lines = table.shape[0]
    read_ids = step["tgt"].clamp(max=n_lines - 1)  # as updated_lines reads
    calls = (("forward", step["gather_ids"], G, D, torch.bfloat16,
              step["emb"], V),
             ("row-update read", read_ids, 1, LANES, torch.float32, None,
              n_lines))
    err, ctl = 0.0, {}
    for what, ids, group, dim, dt, got, ids_end in calls:
        if got is None:
            got = k1.gather_rows(table, ids, group=group, dim=dim,
                                 out_dtype=dt)
        want = k1.gather_rows_plain(table, ids, group=group, dim=dim,
                                    out_dtype=dt)
        torch.cuda.synchronize()
        require(got.dtype == dt and torch.equal(got, want),
                f"K1 training {what}: differs from plain")
        err = max(err, float((got.float() - want.float()).abs().max()))
        del want
        wrong = k1.gather_rows_plain(table, (ids + 1) % ids_end,
                                     group=group, dim=dim, out_dtype=dt)
        ctl[f"K1 {what} ids shifted"] = int((wrong != got).any(1).sum())
        require(ctl[f"K1 {what} ids shifted"] > 0,
                f"K1 training {what} control: shifted ids give the same rows")
        log(f"[train-kernels] K1 {what}: {ids.numel()} ids, group {group}, "
            f"dim {dim} {str(dt).split('.')[-1]} from {tuple(table.shape)}: "
            f"bit-exact vs plain; control: ids shifted by one change "
            f"{ctl[f'K1 {what} ids shifted']} rows")
    return err, ctl


def check_train_kernels(torch, step):
    """K1, K2, K2b, K9 and K4 against their plain versions on the first
    step's inputs, each with a control that must exceed its limit.
    Returns the max errors and the control readings."""
    from goctr_tpu_torch.ops.kernels import compact as k9
    from goctr_tpu_torch.ops.kernels import din_attention as k2
    from goctr_tpu_torch.ops.kernels import row_optimizer as k4

    V, D = step["V"], step["D"]
    errs = {}
    errs["K1"], ctl = check_train_gather(torch, step)
    # K2 forward: the pooled rows the trainer took
    _, beh, item, att0, mask = step["pool"]
    want = k2.din_attention_pool_plain(beh, item, att0, mask)
    torch.cuda.synchronize()
    errs["K2"] = max_err(torch, step["pooled"], want, "bfloat16",
                         "K2 training forward")
    atol, rtol = TOL["bfloat16"]
    ctl["K2 pool zeroed"], _ = within(torch, torch.zeros_like(want), want,
                                      rtol, atol)
    require(ctl["K2 pool zeroed"] > 0,
            "K2 control: a zeroed pool passes the limit")
    log(f"[train-kernels] K2 B,T,D={tuple(beh.shape)} bf16 vs plain: max "
        f"err {errs['K2']:.3g} (tol atol={atol} rtol={rtol}); control: a "
        f"zeroed pool leaves {ctl['K2 pool zeroed']} entries outside")
    del want
    # K2b
    got = k2.din_attention_pool_bwd(*step["pool"])
    want = k2.din_attention_pool_bwd_plain(*step["pool"])
    torch.cuda.synchronize()
    for name, g, w_ in (("d_behaviors", got[0], want[0]),
                        ("d_item", got[1], want[1])):
        atol = GRAD_ATOL_REL * float(w_.float().abs().max())
        bad, err = within(torch, g, w_, GRAD_RTOL_BF16, atol)
        require(bad == 0, f"K2b {name}: {bad} entries outside rtol 2^-7 + "
                          f"atol {atol:.3g} (max err {err:.3g})")
        errs[f"K2b {name}"] = err
    a_atol = ATT0_ATOL_REL * float(want[2].abs().max())
    bad, err = within(torch, got[2], want[2], ATT0_RTOL, a_atol)
    require(bad == 0, f"K2b d_att0: {bad} entries outside rtol {ATT0_RTOL}")
    errs["K2b d_att0"] = err
    atol = GRAD_ATOL_REL * float(want[0].float().abs().max())
    ctl["K2b d_behaviors zeroed"], _ = within(
        torch, torch.zeros_like(want[0]), want[0], GRAD_RTOL_BF16, atol)
    require(ctl["K2b d_behaviors zeroed"] > 0,
            "K2b control: zeroed d_behaviors passes the limit")
    log(f"[train-kernels] K2b B,T,D={tuple(step['pool'][1].shape)} bf16 "
        f"vs plain: max err d_behaviors {errs['K2b d_behaviors']:.3g}, "
        f"d_item {errs['K2b d_item']:.3g}, d_att0 {err:.3g} (limits "
        f"rtol 2^-7 + {GRAD_ATOL_REL}·max; d_att0 rtol {ATT0_RTOL} + "
        f"{ATT0_ATOL_REL}·max); control: zeroed d_behaviors leaves "
        f"{ctl['K2b d_behaviors zeroed']} entries outside")
    del got, want
    # K9
    s_ids, g_s, capr = step["s_ids"], step["g_s"], step["capr"]
    tgt, rows, over = k9.compact_runsums_block(s_ids, g_s, V, capr)
    w_tgt, w_rows, w_over = k9.compact_runsums_plain(s_ids, g_s, V, capr)
    abs_rows = k9.compact_runsums_plain(s_ids, g_s.abs(), V, capr)[1]
    torch.cuda.synchronize()
    require(torch.equal(tgt, w_tgt), "K9: targets differ from plain")
    require(int(over) == int(w_over), "K9: overflow differs from plain")
    lim = RUNSUM_RTOL * abs_rows[:, :D]
    diff = (rows[:, :D] - w_rows[:, :D]).abs()
    require(bool((diff <= lim).all()),
            f"K9: {int((diff > lim).sum())} run-sum entries outside "
            f"{RUNSUM_RTOL}·Σ|g|")
    # ‖Σg‖²: |Δ Σ s²| <= Σ (2|s|·lim + lim²), plus its own f32 rounding
    nsq_lim = (2 * w_rows[:, :D].abs() * lim + lim * lim).sum(1) \
        + 1e-6 * w_rows[:, D]
    require(bool(((rows[:, D] - w_rows[:, D]).abs() <= nsq_lim).all()),
            "K9: ‖Σg‖² lane outside its limit")
    require(bool((rows[:, D + 1:] == 0).all()), "K9: lanes past D not 0")
    errs["K9"] = float(diff.max())
    hot = int(torch.argmax(abs_rows[:, :D].sum(1)))
    zeroed = w_rows.clone()
    zeroed[hot, :D] = 0.0
    ctl["K9 hottest run zeroed"] = int(
        ((rows[:, :D] - zeroed[:, :D]).abs() > lim).sum())
    require(ctl["K9 hottest run zeroed"] > 0,
            "K9 control: a zeroed run sum passes the limit")
    n_real = int((w_tgt < V).sum())
    log(f"[train-kernels] K9 n={s_ids.numel()} D={D} capr={capr}: "
        f"{n_real} real runs (hottest Σ|g| row {hot}), overflow "
        f"{int(over)}; targets equal, max run-sum err {errs['K9']:.3g} "
        f"(limit {RUNSUM_RTOL}·Σ|g|); control: zeroed hottest run leaves "
        f"{ctl['K9 hottest run zeroed']} entries outside")
    del rows, w_rows, abs_rows, zeroed, diff, lim
    # K4 (tables are multi-GB: compare the touched lines, then check the
    # rest by restoring them)
    table, tgt, new, skip = step["table"], step["tgt"], step["new"], \
        step["skip"]
    got_t = k4.scatter_rows_packed(table.clone(), tgt, new, skip_ge=skip)
    want_t = k4.scatter_rows_packed_plain(table.clone(), tgt, new,
                                          skip_ge=skip)
    torch.cuda.synchronize()
    require(torch.equal(got_t, want_t), "K4: table differs from plain")
    del want_t
    real = tgt < skip
    hit = tgt[real].long()
    errs["K4"] = float((got_t[hit] - new[real]).abs().max())
    shifted = torch.where(real, (tgt + 1) % skip, tgt)
    wrong = k4.scatter_rows_packed_plain(table.clone(), shifted, new,
                                         skip_ge=skip)
    ctl["K4 targets shifted"] = int((wrong[hit] != got_t[hit]).any(1).sum())
    del wrong
    require(ctl["K4 targets shifted"] > 0,
            "K4 control: shifted targets give the same table")
    got_t[hit] = table[hit]
    require(torch.equal(got_t, table), "K4: an untouched line changed")
    del got_t
    log(f"[train-kernels] K4 {tgt.numel()} slots, {int(real.sum())} real "
        f"lines into {tuple(table.shape)}: bit-exact vs plain, untouched "
        f"lines unchanged; control: shifted targets change "
        f"{ctl['K4 targets shifted']} lines")
    return errs, ctl


def rmw_kernel(step):
    """(name, kernel wrapper, plain version, split update) of the
    one-pass row update of this step's table: K5 on [V, 128] rows, K6 on
    grouped lines."""
    from goctr_tpu_torch.ops.kernels import row_optimizer as ro

    if step["group"] > 1:
        return ("K6", ro.apply_line_updates, ro.apply_line_updates_plain,
                ro.apply_line_updates_split)
    return ("K5", ro.apply_row_updates, ro.apply_row_updates_plain,
            ro.apply_row_updates_split)


def rmw_args(step):
    t = step["topt"]
    return dict(lr=t.lr, d=step["D"], kind=t.kind, eps=t.eps,
                skip_ge=step["skip"])


def check_rmw(torch, step):
    """K5 or K6 against its plain version on the first step's update
    stream (f32 TOL on every updated line; every other line unchanged),
    with a control: the plain version with each real target shifted by
    one line must leave entries outside the limit. Returns (max error,
    controls)."""
    name, kern, plain, _ = rmw_kernel(step)
    table, tgt, upd = step["table"], step["tgt"], step["upd"]
    kw = rmw_args(step)
    got = kern(table.clone(), tgt, upd, **kw)
    want = plain(table.clone(), tgt, upd, **kw)
    torch.cuda.synchronize()
    real = tgt < kw["skip_ge"]
    hit = tgt[real].long()
    err = max_err(torch, got[hit], want[hit], "float32",
                  f"{name} updated lines")
    del want
    require(bool((got[hit] != table[hit]).any(1).all()),
            f"{name}: an updated line kept its value")
    shifted = torch.where(real, (tgt + 1) % kw["skip_ge"], tgt)
    wrong = plain(table.clone(), shifted, upd, **kw)
    atol, rtol = TOL["float32"]
    ctl = {f"{name} targets shifted": within(torch, got[hit], wrong[hit],
                                             rtol, atol)[0]}
    del wrong
    require(ctl[f"{name} targets shifted"] > 0,
            f"{name} control: shifted targets pass the limit")
    got[hit] = table[hit]
    require(torch.equal(got, table), f"{name}: an untouched line changed")
    log(f"[train-kernels] {name} {tgt.numel()} slots, {int(real.sum())} "
        f"real lines of {tuple(table.shape)} ({kw['kind']}, d={kw['d']}, "
        f"group {step['group']}) vs plain: max err {err:.3g} (tol atol="
        f"{atol} rtol={rtol}), untouched lines unchanged; control: shifted "
        f"targets leave {ctl[f'{name} targets shifted']} entries outside")
    return err, ctl


def exact_update(torch, table, ids, sums, err, topt, D):
    """The exact update of the distinct lines `ids` of `table` from their
    exact run sums `sums` [m, D] (f64), and a bound on how far an f32
    kernel's lines may lie from it when its run sums are within `err`
    [m, D] of the exact ones: (x, bound), each [m, D + 1] f64 (weight
    lanes, then the accumulator lane). adagrad: acc' = acc + ‖Σg‖², w' = w
    − lr·Σg·(acc' + eps)^-1/2; sgd: w' = w − lr·Σg. The bound carries err
    through the update to first order and adds the f32 rounding of each
    operation (u = 2^-24 a rounding; ‖Σg‖² d squares and d adds; rsqrtf
    2 ulps), doubled to cover the terms of second order."""
    u = 2.0 ** -24
    line = table[ids].double()
    w, acc = line[:, :D], line[:, D]
    if topt.kind == "sgd":
        x_w = w - topt.lr * sums
        b_w = topt.lr * err + 2 * u * (w.abs() + topt.lr * sums.abs())
        x_a, b_a = acc, torch.zeros_like(acc)
    else:
        nsq = (sums * sums).sum(1)
        x_a = acc + nsq
        b_a = ((2 * sums.abs() * err + err * err).sum(1)
               + (2 * D + 2) * u * nsq + u * x_a)
        scale = topt.lr / torch.sqrt(x_a + topt.eps)
        b_s = scale * (0.5 * b_a / (x_a + topt.eps) + 4 * u)
        x_w = w - scale[:, None] * sums
        b_w = (scale[:, None] * err + sums.abs() * b_s[:, None]
               + 2 * u * (w.abs() + scale[:, None] * sums.abs()))
    return (torch.cat([x_w, x_a[:, None]], 1),
            2 * torch.cat([b_w, b_a[:, None]], 1))


def check_sorted_kernels(torch, step):
    """K7 (on the cumsum of the sorted stream) and K8 (on its rows)
    against their plain versions on the first step's sorted stream, held
    to a limit derived from this stream: the exact update of each real
    line (f64 run sums, `exact_update`) and each version's distance from
    it. K7's run sums are the f32 cumsum differences the plain version
    takes too (their distance from the exact sums is measured); K8 sums a
    run in tile order, whose f32 error is at most (min(len, 128) +
    2·len/128 + 4)·u·Σ|g| (the adds each row passes through: its tile's,
    the carry chain's over tiles and groups, the head's). Each kernel must lie within its bound
    of the exact update, and so within bound + |plain − exact| of its
    plain version; the plain version fed the ids shifted by one (control)
    and fed its stream rolled by one position (controls) must leave
    entries outside that limit. Untouched lines and lanes
    past D stay as they were. Returns (max errors, controls)."""
    from goctr_tpu_torch.ops.kernels import row_optimizer as ro
    from goctr_tpu_torch.ops.kernels import run_optimizer as k8
    from goctr_tpu_torch.ops.segsum import _cumsum_rows

    V, D, table, topt = step["V"], step["D"], step["table"], step["topt"]
    s_ids, g_s = step["s_ids"], step["g_s"]
    n, dev = s_ids.numel(), s_ids.device
    kw = dict(lr=topt.lr, d=D, kind=topt.kind, eps=topt.eps, skip_ge=V)
    # the runs of the stream (ids >= 0: pads carry V)
    start = torch.ones(n, dtype=torch.bool, device=dev)
    start[1:] = s_ids[1:] != s_ids[:-1]
    run = torch.cumsum(start.long(), 0) - 1
    first = torch.nonzero(start).flatten()
    last = torch.cat([first[1:] - 1, first.new_full((1,), n - 1)])
    real = s_ids[first] < V
    ids = s_ids[first][real].long()
    first, last = first[real], last[real]
    n_runs = int(start.sum())
    sums = torch.zeros((n_runs, D), dtype=torch.float64, device=dev
                       ).index_add_(0, run, g_s.double())[real]
    abs_sums = torch.zeros((n_runs, D), dtype=torch.float64, device=dev
                           ).index_add_(0, run, g_s.abs().double())[real]
    length = (last - first + 1).double()
    c = _cumsum_rows(g_s)
    prev = torch.where((first > 0)[:, None], c[(first - 1).clamp_min(0)],
                       0.0)
    err7 = ((c[last] - prev).double() - sums).abs()
    err8 = ((length.clamp(max=128) + 2 * length / 128 + 4)[:, None]
            * 2.0 ** -24 * abs_sums)
    del prev, abs_sums
    shifted = torch.where(s_ids < V, s_ids + 1, s_ids)
    errs, ctl = {}, {}
    for name, kern, plain, rows, err in (
            ("K7", ro.apply_csum_updates, ro.apply_csum_updates_plain, c,
             err7),
            ("K8", k8.apply_run_updates, k8.apply_run_updates_plain, g_s,
             err8)):
        x, bound = exact_update(torch, table, ids, sums, err, topt, D)
        got = kern(table.clone(), s_ids, rows, **kw)
        want = plain(table.clone(), s_ids, rows, **kw)
        torch.cuda.synchronize()
        k_lines = got[ids][:, :D + 1].double()
        p_dist = (want[ids][:, :D + 1].double() - x).abs()
        k_dist = (k_lines - x).abs()
        require(bool((k_dist <= bound).all()),
                f"{name}: {int((k_dist > bound).sum())} entries farther "
                f"from the exact update than the bound")
        lim = bound + p_dist
        diff = (k_lines - want[ids][:, :D + 1].double()).abs()
        require(bool((diff <= lim).all()),
                f"{name}: {int((diff > lim).sum())} entries outside the "
                f"limit of the plain version")
        errs[name] = float(diff.max())
        require(torch.equal(got[ids][:, D + 1:], table[ids][:, D + 1:]),
                f"{name}: a lane past D changed")
        del want
        for what, wrong_ids, wrong_rows in (
                ("ids shifted", shifted, rows),
                ("stream rolled", s_ids, rows.roll(1, 0))):
            wrong = plain(table.clone(), wrong_ids, wrong_rows, **kw)
            ctl[f"{name} {what}"] = int(
                ((k_lines - wrong[ids][:, :D + 1].double()).abs()
                 > lim).sum())
            del wrong
            require(ctl[f"{name} {what}"] > 0,
                    f"{name} control: {what} passes the limit")
        got[ids] = table[ids]
        require(torch.equal(got, table), f"{name}: an untouched line changed")
        log(f"[train-kernels] {name} n={n} D={D}: {ids.numel()} real runs "
            f"(longest {int(length.max())} rows) vs plain: max err "
            f"{errs[name]:.3g}, max limit {float(lim.max()):.3g} (exact "
            f"update ± bound, + the plain version's distance from it: max "
            f"{float(p_dist.max()):.3g}); kernel within its bound of the "
            f"exact update (max distance {float(k_dist.max()):.3g}); "
            f"untouched lines unchanged; controls: ids shifted by one leave "
            f"{ctl[f'{name} ids shifted']} entries outside, the "
            f"{'cumsum rows' if name == 'K7' else 'rows'} rolled by one "
            f"position {ctl[f'{name} stream rolled']}")
        del got, x, bound, k_lines, k_dist, p_dist, lim, diff
    return errs, ctl


def time_sorted_kernels(torch, step):
    """Device ms of K7 and K8 and their plain versions on the first step's
    sorted stream, with their bounds, and of the fused path's update of
    the same stream: the split update (rank-sort compaction, K1 read,
    torch, K4) and K9 + K5. The timed updates run on the step's own copy
    of the table."""
    from goctr_tpu_torch.ops.kernels import compact as k9
    from goctr_tpu_torch.ops.kernels import row_optimizer as ro
    from goctr_tpu_torch.ops.kernels import run_optimizer as k8
    from goctr_tpu_torch.ops.segsum import _cumsum_rows
    from goctr_tpu_torch.parallel import scanned as sc

    V, D, table, topt = step["V"], step["D"], step["table"], step["topt"]
    s_ids, g_s, capr = step["s_ids"], step["g_s"], step["capr"]
    n = s_ids.numel()
    kw = dict(lr=topt.lr, d=D, kind=topt.kind, eps=topt.eps, skip_ge=V)
    c = _cumsum_rows(g_s)
    end = torch.ones(n, dtype=torch.bool, device=s_ids.device)
    end[:-1] = s_ids[1:] != s_ids[:-1]
    m = int((end & (s_ids < V)).sum())           # real runs
    n_in = int((s_ids < V).sum())                # rows of real ids
    live = -(-4 * (D + 1) // 32) * 32            # sectors of a line's lanes

    def split(i):
        tgt, rows, _ = sc._compact_xla(s_ids, g_s, V, capr)
        ro.apply_row_updates_split(table, tgt, ro.pack_grads(rows), **kw)

    def k9_k5(i):
        tgt, packed, _ = k9.compact_runsums_block(s_ids, g_s, V, capr)
        ro.apply_row_updates(table, tgt, packed, **kw)

    fused = dict(split_ms=device_ms(torch, split, 1, iters=6),
                 k9_k5_ms=device_ms(torch, k9_k5, 1))
    k8_parts = []
    out = {
        "K7": dict(
            ms=device_ms(torch, lambda i: ro.apply_csum_updates(
                table, s_ids, c, **kw), 1),
            plain_ms=device_ms(torch, lambda i: ro.apply_csum_updates_plain(
                table, s_ids, c, **kw), 1, iters=6),
            cumsum_ms=device_ms(torch, lambda i: _cumsum_rows(g_s), 1),
            bytes=n * 4 + m * D * 4 + m * live * 2,
            flops=m * ((D + 1) * 8 + D)),
        "K8": dict(
            ms=device_ms(torch, lambda i: k8.apply_run_updates(
                table, s_ids, g_s, **kw), 1, by_kernel=k8_parts),
            plain_ms=device_ms(torch, lambda i: k8.apply_run_updates_plain(
                table, s_ids, g_s, **kw), 1, iters=6),
            bytes=n * 4 + n_in * D * 4 + m * live * 2,
            flops=n_in * D + m * (D + 1) * 8)}
    for key, r in out.items():
        r.update(fused, library_ms=None)
        r["bound_ms"] = max(r["bytes"] / HBM_BYTES_PER_S,
                            r["flops"] / F32_FLOPS_PER_S) * 1e3
        r["bound_by"] = ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                         >= r["flops"] / F32_FLOPS_PER_S else "operations")
        extra = ("" if "cumsum_ms" not in r else
                 f", the cumsum before it {r['cumsum_ms']:.5f}")
        log(f"[train-kernels] {key} device ms per call: kernel "
            f"{r['ms']:.5f}, plain {r['plain_ms']:.5f}{extra}, bound "
            f"{r['bound_ms']:.5f} ({r['bytes']} B, {r['flops']} flop, "
            f"{r['bound_by']}); the fused path's update of the same stream: "
            f"split (rank-sort compaction, K1 read, torch, K4) "
            f"{r['split_ms']:.5f}, K9 + K5 {r['k9_k5_ms']:.5f}")
    log("[train-kernels] K8 by kernel, device ms per call: "
        + ", ".join(f"{kernel_name(key)} {ms:.5f}" for ms, key in k8_parts))
    return out


def time_train_kernels(torch, step):
    """Device ms of K2b, K9, K4 and K5 or K6 and their plain versions
    (K4's library call; the split update beside the one-pass one) on the
    first step's inputs, with their bounds. The timed updates run on the
    step's own copy of the table."""
    from goctr_tpu_torch.ops.kernels import compact as k9
    from goctr_tpu_torch.ops.kernels import din_attention as k2
    from goctr_tpu_torch.ops.kernels import row_optimizer as k4

    V, D = step["V"], step["D"]
    pool = step["pool"]
    B, T, _ = pool[1].shape
    out = {}
    b2 = (2 * B * T * D * 2 + 3 * B * D * 2 + B * T * 4 + 2 * T * 4)
    f2 = B * T * (13 * D + 30)
    out["K2b"] = dict(
        ms=device_ms(torch, lambda i: k2.din_attention_pool_bwd(*pool), 1),
        plain_ms=device_ms(torch, lambda i: k2.din_attention_pool_bwd_plain(
            *pool), 1, iters=6),
        library_ms=None, bytes=b2, flops=f2)
    s_ids, g_s, capr = step["s_ids"], step["g_s"], step["capr"]
    n = s_ids.numel()
    out["K9"] = dict(
        ms=device_ms(torch, lambda i: k9.compact_runsums_block(
            s_ids, g_s, V, capr), 1),
        plain_ms=device_ms(torch, lambda i: k9.compact_runsums_plain(
            s_ids, g_s, V, capr), 1, iters=6),
        library_ms=None, bytes=n * 4 + n * D * 4 + capr * (512 + 4) + 4,
        flops=n * D)
    table, tgt, new, skip = step["table"], step["tgt"], step["new"], \
        step["skip"]
    real = tgt < skip
    n_real = int(real.sum())
    ids_real, rows_real = tgt[real].long(), new[real]
    out["K4"] = dict(
        ms=device_ms(torch, lambda i: k4.scatter_rows_packed(
            table, tgt, new, skip_ge=skip), 1),
        plain_ms=device_ms(torch, lambda i: k4.scatter_rows_packed_plain(
            table, tgt, new, skip_ge=skip), 1, iters=6),
        library_ms=device_ms(torch, lambda i: table.index_copy_(
            0, ids_real, rows_real), 1),
        bytes=tgt.numel() * 4 + n_real * 512 * 2, flops=0)
    # the one-pass update: ids once; of each real line and its update row,
    # the 32-byte sectors that hold the G·(D+1) live lanes, the line's read
    # and written, the update row's read; ~8 f32 operations a live lane
    name, kern, plain, split = rmw_kernel(step)
    upd, kw = step["upd"], rmw_args(step)
    live = step["group"] * (D + 1)
    live_bytes = -(-4 * live // 32) * 32
    out[name] = dict(
        ms=device_ms(torch, lambda i: kern(table, tgt, upd, **kw), 1),
        plain_ms=device_ms(torch, lambda i: plain(table, tgt, upd, **kw), 1,
                           iters=6),
        split_ms=device_ms(torch, lambda i: split(table, tgt, upd, **kw), 1),
        library_ms=None, bytes=tgt.numel() * 4 + n_real * live_bytes * 3,
        flops=n_real * live * 8)
    for key, r in out.items():
        r["bound_ms"] = max(r["bytes"] / HBM_BYTES_PER_S,
                            r["flops"] / F32_FLOPS_PER_S) * 1e3
        r["bound_by"] = ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                         >= r["flops"] / F32_FLOPS_PER_S else "operations")
        lib = ("" if r["library_ms"] is None
               else f", index_copy_ {r['library_ms']:.5f}")
        split_ = ("" if "split_ms" not in r else
                  f", split update (K1 read + torch + K4) "
                  f"{r['split_ms']:.5f}")
        log(f"[train-kernels] {key} device ms per call: kernel "
            f"{r['ms']:.5f}, plain {r['plain_ms']:.5f}{lib}{split_}, bound "
            f"{r['bound_ms']:.5f} ({r['bytes']} B, {r['flops']} flop, "
            f"{r['bound_by']})")
    return out


def profile_steps(torch, step, tag, steps=3):
    """Device time by kernel and idle share over `steps` calls of step(i)
    after one warm-up call, torch.profiler; plus the unprofiled latency
    over 5 calls. Returns the readings and the (us, count, key) rows."""
    from torch.profiler import ProfilerActivity, profile

    step(0)
    torch.cuda.synchronize()
    lat = []
    for i in range(5):
        t0 = time.perf_counter()
        step(i + 1)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_events(prof)
    busy = sum(r[0] for r in rows)
    log(f"[{tag}] {steps} steps: wall {wall_us / 1e3 / steps:.3f} "
        f"ms/step, device busy {busy / 1e3 / steps:.3f} ms/step (idle share "
        f"{max(0.0, 1 - busy / wall_us):.3f}); unprofiled step latency "
        f"median {np.median(lat) * 1e3:.3f} ms, max {max(lat) * 1e3:.3f} ms")
    for us, count, key in rows[:24]:
        log(f"[{tag}]   device {us / steps / 1e3:9.4f} ms/step "
            f"x{count // steps:<4d} {key[:90]}")
    return {"busy_ms": busy / 1e3 / steps, "wall_ms": wall_us / 1e3 / steps,
            "lat_ms": float(np.median(lat) * 1e3), "rows": rows,
            "steps": steps}


def profile_train_steps(torch, result, sample, cfg, topt, dev, steps=3):
    """profile_steps over training steps of the scanned trainer's result
    (a copy of its model, table and solver state)."""
    import copy

    from goctr_tpu_torch.ops.kernels.row_optimizer import pack_table
    from goctr_tpu_torch.parallel import scanned as sc

    bs = cfg.batch_size
    model = copy.deepcopy(result.model)
    table = (result.table.clone() if result.packed_group > 1
             else pack_table(result.table, result.acc))
    solver = sc.make_trainer_solver(cfg)
    state = [x.clone() for x in result.opt_state]
    batches = []
    for b in range(4):
        sl = slice(b * bs, (b + 1) * bs)
        batches.append([torch.from_numpy(np.ascontiguousarray(a[sl])).to(dev)
                        for a in (sample.user_profile, sample.behavior_ids,
                                  sample.item_ids, sample.ctx,
                                  sample.labels)]
                       + [torch.ones(bs, device=dev)])

    def step(i):
        nonlocal state
        _, _, state = sc.train_step(model, table, solver, state,
                                    *batches[i % 4], topt)

    return profile_steps(torch, step, "train-profile", steps)


def small_train_check(torch, dev, emb_dim, cases):
    """A small f32 model trained 3 epochs on the card (kernels) and by the
    port on the CPU (plain versions) from the same start, for each
    TableOptConfig change of `cases` (compaction, row update, update
    mode). At emb_dim < 64 the start is grouped lines: `fused` keeps them
    (GROUPED_RESIDENT_MIN_V lowered for the check) and is compared line
    for line; the other modes unpack them and return [rows, D] + acc
    (runfused and fused2 train [V, 128] rows, one a line)."""
    from goctr_tpu_torch.models.trainer import TrainerConfig
    from goctr_tpu_torch.ops.kernels.row_optimizer import (
        group_size, pack_table_grouped)
    from goctr_tpu_torch.parallel import scanned as sc
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
    from goctr_tpu_torch.parallel.sparse_trainer import SparseSample

    rng = np.random.default_rng(SEED + 4)
    n, vocab = 3000, 400
    sample = SparseSample(
        user_profile=rng.random((n, 4)).astype(np.float32),
        behavior_ids=rng.integers(-1, vocab, (n, 5)).astype(np.int32),
        item_ids=rng.integers(0, vocab, n).astype(np.int32),
        ctx=rng.random((n, 2)).astype(np.float32),
        labels=(rng.random(n) > 0.5).astype(np.float32))
    cfgd = dict(item_vocab=vocab, emb_dim=emb_dim, u_profile_dim=4,
                ctx_dim=2, behavior_len=5, hidden=(16,))
    m0 = SparseCTR(**cfgd, device="cpu")
    table0 = m0.init_params(torch.Generator().manual_seed(SEED))
    G = group_size(emb_dim)
    if G > 1:
        table0 = pack_table_grouped(table0)
    worst = [0.0, 0.0]
    resident_min = sc.GROUPED_RESIDENT_MIN_V
    sc.GROUPED_RESIDENT_MIN_V = 0
    try:
        for change in cases:
            out = {}
            topt = sc.TableOptConfig(kind="adagrad", lr=0.3, **change)
            for d in ("cpu", dev):
                m = SparseCTR(**cfgd, device="cpu")
                m.load_state_dict(m0.state_dict())
                out[str(d)] = sc.train_sparse_scanned(
                    SparseCTR(**cfgd, device=d), sample,
                    TrainerConfig(batch_size=1024, epochs=3, early_stop=0,
                                  shuffle=False),
                    topt, resume_from=sc.TrainedScanned(
                        model=m, table=table0.clone(), loss_curve=[],
                        packed_group=G), device=d)
            c, g = out["cpu"], out[str(dev)]
            group = sc.table_group(topt.update_mode, emb_dim)
            require(g.packed_group == c.packed_group == group,
                    f"small trainer: packed_group {g.packed_group}")
            lc = np.abs(np.array(g.loss_curve) - c.loss_curve) / np.abs(
                c.loss_curve)
            worst[0] = max(worst[0], float(lc.max()))
            what = f"small trainer D={emb_dim} {change}"
            require(lc.max() <= TRAJ_LOSS_RTOL,
                    f"{what}: loss curves differ by {lc.max():.3g} (rtol "
                    f"{TRAJ_LOSS_RTOL})")
            pairs = [("table", g.table, c.table)]
            if group == 1:
                pairs.append(("acc", g.acc, c.acc))
            for name, x, y in pairs:
                bad, err = within(torch, x.cpu(), y, TRAJ_TABLE_RTOL,
                                  TRAJ_TABLE_ATOL)
                worst[1] = max(worst[1], err)
                require(bad == 0, f"{what}: {name} {bad} entries outside "
                                  f"(max err {err:.3g})")
    finally:
        sc.GROUPED_RESIDENT_MIN_V = resident_min
    log(f"[train] small f32 trainer D={emb_dim} (G={G}), card (kernels) vs "
        f"CPU (plain), {len(cases)} configurations {cases}, 3 epochs: max "
        f"loss rel "
        f"diff {worst[0]:.3g} (rtol {TRAJ_LOSS_RTOL}), max table/acc err "
        f"{worst[1]:.3g} (rtol {TRAJ_TABLE_RTOL}, atol {TRAJ_TABLE_ATOL})")


def compaction_controls(torch, sample, cfg, topt, start, dev, loss0):
    """One epoch of the kernel-compaction run from `start` for each wrong
    compaction below (K9's output changed on the device, every step), and
    the relative distance of its first-epoch loss from `loss0`, the xla
    run's. Each must exceed LOSS_RTOL_IMPL, or the loss check could not
    catch a wrong compaction. Returns the readings."""
    import dataclasses

    from goctr_tpu_torch.parallel import scanned as sc
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR

    D = HEADLINE["emb_dim"]

    def largest_zeroed(tgt, rows, over):
        hot = rows[:, D].argmax().view(1)          # the largest ‖Σg‖²
        return tgt, rows.index_fill(0, hot, 0.0), over

    def sums_shifted(tgt, rows, over):
        # each real target takes its predecessor's run sum; the last real
        # sum lands in the first junk slot, which the scatter skips
        return tgt, rows.roll(1, 0), over

    real = sc.compact_runsums_block
    readings = {}
    try:
        for name, corrupt in (("largest run sum zeroed", largest_zeroed),
                              ("run sums shifted one slot", sums_shifted)):
            sc.compact_runsums_block = (
                lambda *a, corrupt=corrupt: corrupt(*real(*a)))
            r = sc.train_sparse_scanned(
                SparseCTR(**HEADLINE, compute_dtype=torch.bfloat16,
                          device=dev),
                sample, dataclasses.replace(cfg, epochs=1),
                dataclasses.replace(topt, compact_impl="kernel"),
                resume_from=start, device=dev)
            readings[name] = abs(r.loss_curve[0] - loss0) / abs(loss0)
            del r
    finally:
        sc.compact_runsums_block = real
    log(f"[train] compaction controls, first-epoch loss rel diff from xla "
        f"(must exceed {LOSS_RTOL_IMPL}): "
        + ", ".join(f"{k} {v:.3g}" for k, v in readings.items()))
    for name, v in readings.items():
        require(v > LOSS_RTOL_IMPL,
                f"compaction control '{name}': loss rel diff {v:.3g} is "
                f"inside the limit {LOSS_RTOL_IMPL}, which therefore "
                f"cannot catch it")
    return readings


def update_mode_controls(torch, sample, cfg, topt, start, dev, loss0):
    """One epoch of each sorted-stream mode from `start` with its kernel
    writing each run's update to the line of the next id (its real ids
    shifted by one, every step), and the relative distance of each
    first-epoch loss from `loss0`, the split run's. Each must exceed
    LOSS_RTOL_IMPL, or the loss check could not catch a wrong K7 or K8.
    (The stream rolled by one position, a subtler fault, moves this loss
    by only 2e-6 to 5e-6 on an H100, PERF.md: check_sorted_kernels holds
    it at the kernel.) Returns the readings."""
    import dataclasses

    from goctr_tpu_torch.parallel import scanned as sc
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR

    V = HEADLINE["item_vocab"]
    readings = {}
    for name, attr, mode in (("K7 ids shifted", "apply_csum_updates",
                              "fused2"),
                             ("K8 ids shifted", "apply_run_updates",
                              "runfused")):
        real = getattr(sc, attr)
        try:
            setattr(sc, attr, lambda table, s_ids, rows, real=real, **kw:
                    real(table, torch.where(s_ids < V, s_ids + 1, s_ids),
                         rows, **kw))
            r = sc.train_sparse_scanned(
                SparseCTR(**HEADLINE, compute_dtype=torch.bfloat16,
                          device=dev),
                sample, dataclasses.replace(cfg, epochs=1),
                dataclasses.replace(topt, update_mode=mode),
                resume_from=start, device=dev)
        finally:
            setattr(sc, attr, real)
        readings[name] = abs(r.loss_curve[0] - loss0) / abs(loss0)
        del r
    log(f"[train] update-mode controls, first-epoch loss rel diff from "
        f"split (must exceed {LOSS_RTOL_IMPL}): "
        + ", ".join(f"{k} {v:.3g}" for k, v in readings.items()))
    for name, v in readings.items():
        require(v > LOSS_RTOL_IMPL,
                f"update-mode control '{name}': loss rel diff {v:.3g} is "
                f"inside the limit {LOSS_RTOL_IMPL}, which therefore "
                f"cannot catch it")
    return readings


def counted_kernels():
    """The launch-counted wrappers of the training paths, by name."""
    from goctr_tpu_torch.ops.kernels import compact as k9
    from goctr_tpu_torch.ops.kernels import din_attention as k2
    from goctr_tpu_torch.ops.kernels import row_gather as k1
    from goctr_tpu_torch.ops.kernels import row_optimizer as ro
    from goctr_tpu_torch.ops.kernels import run_optimizer as k8

    from goctr_tpu_torch.ops.kernels import embedding_lookup as k3

    return {f.__name__: f for f in (
        k1.gather_rows, k2.din_attention_pool, k2.din_attention_pool_bwd,
        ro.scatter_rows_packed, k9.compact_runsums_block,
        ro.apply_row_updates, ro.apply_line_updates, ro.apply_csum_updates,
        k8.apply_run_updates, k3.fused_gather_pool)}


def line_update_controls(torch, sample, cfg, topt, start, dev, loss0):
    """One epoch of the one-pass run from `start` with K6 writing each
    update to the line of the slot before it (its line ids rolled by one:
    still distinct), and the relative distance of its first-epoch loss
    from `loss0`, the split run's. It must exceed LOSS_RTOL_IMPL, or the
    loss check could not catch a wrong line update. Returns the reading."""
    import dataclasses

    from goctr_tpu_torch.parallel import scanned as sc
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR

    real = sc.apply_line_updates
    try:
        sc.apply_line_updates = (
            lambda table, ids, upd, **kw: real(table, ids.roll(1, 0), upd,
                                               **kw))
        r = sc.train_sparse_scanned(
            SparseCTR(**GROUPED, compute_dtype=torch.bfloat16, device=dev),
            sample, dataclasses.replace(cfg, epochs=1),
            dataclasses.replace(topt, rmw_impl="kernel",
                                compact_impl="kernel"),
            resume_from=start, device=dev)
    finally:
        sc.apply_line_updates = real
    reading = abs(r.loss_curve[0] - loss0) / abs(loss0)
    log(f"[grouped-train] line-update control, first-epoch loss rel diff "
        f"from split (must exceed {LOSS_RTOL_IMPL}): K6 on the neighbour "
        f"slot's line {reading:.3g}")
    require(reading > LOSS_RTOL_IMPL,
            f"line-update control: loss rel diff {reading:.3g} is inside "
            f"the limit {LOSS_RTOL_IMPL}, which therefore cannot catch it")
    return {"K6 neighbour line": reading}


def train_phase(torch, dev, gen, reqs, kernels, tag, model_cfg, rows,
                small_cases, variants, controls, pair=()):
    """Phases 6 and 7: `model_cfg` trained at full width on `rows` rows of
    the JAX bench workload, batch TRAIN_BATCH, from a start drawn from
    `gen` (the table as the trainer keeps it: [V, D] rows, or grouped lines
    when D packs G > 1 rows a line). On the first step's inputs, K1, K2,
    K2b, K9, K4 and the one-pass update (K5 or K6) are held against their
    plain versions and timed, and K7 and K8 too when a variant trains
    fused2 or runfused; `small_cases` are the small card-vs-CPU trainers.
    The main path, counts reset just before and read just after:
    TRAIN_EPOCHS epochs with the split update and xla compaction, one
    epoch from the same start for each (label, TableOptConfig change) of
    `variants`, whose first-epoch losses must agree with the main run's,
    and one epoch each of the two modes of `pair`, whose losses must be
    finite and agree with each other. Each function of `controls` shows
    that the limit catches a wrong update. Then 3 profiled steps, and the
    trained result serves. Returns (times, max errors, main-path
    launches) of the kernels it checks."""
    import dataclasses

    from goctr_tpu_torch.models.trainer import TrainerConfig
    from goctr_tpu_torch.ops.kernels.row_optimizer import group_size
    from goctr_tpu_torch.parallel.scanned import (
        TableOptConfig, TrainedScanned, table_pad_rows, train_sparse_scanned)
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
    from goctr_tpu_torch.serve.scorer import DeviceScorer

    V, T, D = model_cfg["item_vocab"], model_cfg["behavior_len"], \
        model_cfg["emb_dim"]
    G = group_size(D)
    t_phase = time.perf_counter()
    sample = make_workload(rows, V, T, model_cfg["u_profile_dim"],
                           model_cfg["ctx_dim"], seed=SEED)
    cap = bench_compact_cap(sample, TRAIN_BATCH)
    steps = -(-rows // TRAIN_BATCH)
    log(f"[{tag}] workload {rows} rows ({steps} steps of {TRAIN_BATCH}, "
        f"the last with {steps * TRAIN_BATCH - rows} padded rows) in "
        f"{time.perf_counter() - t_phase:.1f} s; compact_cap {cap}")
    cfg = TrainerConfig(batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS,
                        early_stop=0, lr=1e-3, shuffle=True, seed=SEED)
    topt = TableOptConfig(kind="adagrad", lr=TABLE_LR, compact_cap=cap,
                          compact_impl="xla")
    model0 = SparseCTR(**model_cfg, compute_dtype=torch.bfloat16, device=dev)
    start = TrainedScanned(model=model0,
                           table=model0.init_params(gen, table_group=G),
                           loss_curve=[], packed_group=G)
    shape = tuple(start.table.shape)
    log(f"[{tag}] start: table {shape} f32 "
        f"({start.table.numel() * 4 / 1e9:.2f} GB), G={G}")
    modes = {change.get("update_mode", "fused") for _, change in variants}
    sorted_modes = modes & {"fused2", "runfused"}

    step = first_step(torch, start, sample, cfg, topt, dev)
    errs, ctl = check_train_kernels(torch, step)
    name, rmw, _, _ = rmw_kernel(step)
    errs[name], c = check_rmw(torch, step)
    ctl.update(c)
    if sorted_modes:
        e, c = check_sorted_kernels(torch, step)
        errs.update(e)
        ctl.update(c)
    times = time_train_kernels(torch, step)
    if sorted_modes:
        times.update(time_sorted_kernels(torch, step))
    del step
    torch.cuda.empty_cache()
    small_train_check(torch, dev, D, small_cases)

    # the main path: counts reset just before, read just after
    path = ["gather_rows", "din_attention_pool", "din_attention_pool_bwd",
            "scatter_rows_packed", "compact_runsums_block", rmw.__name__]
    path += [k for m, k in (("fused2", "apply_csum_updates"),
                            ("runfused", "apply_run_updates"))
             if m in sorted_modes]
    counted = counted_kernels()
    for f in counted.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()

    def run(**change):
        r = train_sparse_scanned(
            SparseCTR(**model_cfg, compute_dtype=torch.bfloat16, device=dev),
            sample, dataclasses.replace(cfg, epochs=1) if change else cfg,
            dataclasses.replace(topt, **change), resume_from=start,
            device=dev)
        mode = change.get("update_mode", "fused")
        # the result's layout: the start's lines (or [V, D] + acc) in
        # fused, [V, D] + acc in the other modes ([V + pad, D] in dedup)
        want = ((shape, G, G > 1) if mode == "fused" else
                ((V + (table_pad_rows(TRAIN_BATCH, T) if mode == "dedup"
                       else 0), D), 1, False))
        require((tuple(r.table.shape), r.packed_group, r.acc is None)
                == want, f"{tag} {mode}: the result is not the trained "
                         f"table {tuple(r.table.shape)}")
        require(r.update_overflow_max == 0, f"{tag}: compact_cap overflowed")
        return r

    r_main = run()
    others = {}
    for what, change in (*variants, *pair):
        r = run(**change)
        others[what] = (r.loss_curve[0], r.epoch_times[0])
        del r
    launches = {k: f.launches for k, f in counted.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    require(all(launches[k] > 0 for k in path),
            f"{tag}: a kernel of the path was never launched {launches}")
    lc = r_main.loss_curve
    require(all(np.isfinite(lc)) and lc[-1] < lc[0],
            f"{tag}: the loss does not fall {lc}")
    rel = {}
    for what, _ in variants:
        rel[what] = abs(others[what][0] - lc[0]) / abs(lc[0])
        require(rel[what] <= LOSS_RTOL_IMPL,
                f"{tag}: first-epoch loss split/xla {lc[0]} vs {what} "
                f"{others[what][0]} (rel {rel[what]:.3g} > "
                f"{LOSS_RTOL_IMPL})")
    pair_line = ""
    if pair:
        (a, _), (b, _) = pair
        la, lb = others[a][0], others[b][0]
        require(np.isfinite(la) and np.isfinite(lb),
                f"{tag}: {a} / {b} losses not finite: {la}, {lb}")
        rel[f"{a} vs {b}"] = abs(la - lb) / abs(lb)
        require(rel[f"{a} vs {b}"] <= LOSS_RTOL_PAIR,
                f"{tag}: first-epoch loss {a} {la} vs {b} {lb} (rel "
                f"{rel[f'{a} vs {b}']:.3g} > {LOSS_RTOL_PAIR})")
        pair_line = (f"; per-occurrence adagrad: {a} {la}, {b} {lb} (rel "
                     f"diff {rel[f'{a} vs {b}']:.3g}, limit "
                     f"{LOSS_RTOL_PAIR}; rel to split "
                     f"{abs(la - lc[0]) / abs(lc[0]):.3g})")
    steady = rows * (TRAIN_EPOCHS - 1) / sum(r_main.epoch_times[1:])
    log(f"[{tag}] V={V} D={D} (G={G}), batch {TRAIN_BATCH}, {steps} "
        f"steps/epoch: loss curve (split, xla) {lc}, epoch s "
        f"{r_main.epoch_times}; "
        + "; ".join(f"{what} epoch 1 loss {others[what][0]} (rel diff "
                    f"{rel[what]:.3g}), {others[what][1]:.3f} s"
                    for what, _ in variants)
        + f" (limit {LOSS_RTOL_IMPL})"
        + "".join(f"; {what} epoch {others[what][1]:.3f} s"
                  for what, _ in pair)
        + pair_line + f"; overflow 0; steady-state {steady:.1f} ex/s, step "
        f"{sum(r_main.epoch_times[1:]) / (steps * (TRAIN_EPOCHS - 1)) * 1e3:.3f}"
        f" ms; peak device memory {peak:.2f} GB; launches {launches}")
    for control in controls:
        ctl.update(control(torch, sample, cfg, topt, start, dev, lc[0]))
    del start
    prof = profile_train_steps(torch, r_main, sample, cfg, topt, dev)

    # the trained result serves
    what = "trained headline" if G == 1 else "trained grouped"
    scorer = DeviceScorer.from_scanned(r_main, device=dev)
    p0, b0, c0, k0 = batch(reqs, 0)
    first, rate, _ = drive(torch, kernels, scorer, reqs, what)
    check_scores(first, plain_scores(torch, scorer, p0, b0, c0, k0),
                 SCORE_ATOL_TRAINED, f"{what} kernels vs plain")
    ctl.update(check_controls(torch, scorer, first, p0, b0, c0, k0, what,
                              SCORE_ATOL_TRAINED))
    log(f"[{tag}] done in {time.perf_counter() - t_phase:.1f} s: steady "
        f"{steady:.1f} ex/s, profiled step device busy "
        f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f}; trained "
        f"serving {rate:.1f} scores/s; controls {ctl}")
    return times, errs, launches


# ------------------------------------------------------------- phase 8 --
def device_batch(torch, sample, sl, dev):
    """Rows `sl` of `sample` as a SparseBatch on `dev` (no padding)."""
    from goctr_tpu_torch.parallel.sparse_ctr import SparseBatch

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a[sl], dtype)).to(dev)

    return SparseBatch(user_profile=put(sample.user_profile, np.float32),
                       behavior_ids=put(sample.behavior_ids, np.int32),
                       item_ids=put(sample.item_ids, np.int32),
                       ctx=put(sample.ctx, np.float32),
                       labels=put(sample.labels, np.float32))


def plain_pool_grad(torch, table, ids, g):
    """The mean pool's table gradient for the pooled rows' gradient g,
    by autograd through the plain pool in f64, and the same for |g| (the
    sum of each entry's terms' magnitudes)."""
    v = table.shape[0]
    valid = ids >= 0
    ok = valid & (ids < v)
    idx = torch.where(ok, ids, 0).long()
    count = valid.sum(1, keepdim=True).clamp_min(1).double()
    out = []
    for gg in (g, g.abs()):
        t64 = table.double().requires_grad_()
        with torch.enable_grad():
            pooled = (t64[idx] * ok[..., None]).sum(1) / count
            pooled.backward(gg.double())
        out.append(t64.grad)
        del t64, pooled
    return out


def check_gather_pool(torch, table, id_sets):
    """K3 against its plain version on the dense path's own inputs (the
    first batch's behavior ids, `id_sets[0]`, mean and sum) and at odd
    shapes (B = 8,191 with a fully padded row and ids past the table, K =
    1, D = 16 and D = 128 tables), f32 TOL; GatherPoolMean's gradient
    against autograd through the plain pool (f64), each entry within
    POOL_GRAD_REL of the sum of its terms' magnitudes; controls (ids
    shifted by one, a zeroed pool) that must leave entries outside TOL.
    Times K3 (mean), its plain version and embedding_bag (sum with
    per-sample weights valid / count, prepared outside the timing) over
    the id sets, with the bound: ids and output once each, and each
    distinct row once. Returns (max error, controls, times)."""
    import torch.nn.functional as F

    from goctr_tpu_torch.ops.kernels import embedding_lookup as k3

    v, d = table.shape
    dev = table.device
    ids = id_sets[0]
    b, k = ids.shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    atol, rtol = TOL["float32"]
    errs, ctl = [], {}

    def check(t, x, combiner, what):
        got = k3.fused_gather_pool(t, x, combiner)
        want = k3.fused_gather_pool_plain(t, x, combiner)
        torch.cuda.synchronize()
        errs.append(max_err(torch, got, want, "float32",
                            f"K3 {what} {combiner}"))
        return got, want

    for combiner in ("sum", "mean"):
        got, want = check(table, ids, combiner, "path")
    shifted = torch.where(ids >= 0, (ids + 1) % v, ids)
    ctl["K3 ids shifted"], _ = within(
        torch, k3.fused_gather_pool(table, shifted, "mean"), want, rtol, atol)
    ctl["K3 pool zeroed"], _ = within(torch, torch.zeros_like(want), want,
                                      rtol, atol)
    for name, n in ctl.items():
        require(n > 0, f"K3 control '{name}' passes the limit")
    odd = ids[:8191].clone()
    odd[0] = -1                                    # a fully padded row
    odd[1, 0], odd[2, k - 1] = v, v + 12345        # past the table: NaN
    cases = [("B=8191, padded row, ids past V", table, odd),
             ("K=1", table, ids[:, :1].contiguous())]
    for dd in (16, 128):
        t = torch.randn((1_000_000, dd), generator=gen, device=dev).mul_(0.01)
        cases.append((f"D={dd}", t,
                      torch.where(ids >= 0, ids % 1_000_000, ids)))
    for what, t, x in cases:
        for combiner in ("sum", "mean"):
            got, _ = check(t, x, combiner, what)
            if x is odd:
                require(bool((got[0] == 0).all())
                        and bool(torch.isnan(got[1:3]).all())
                        and not bool(torch.isnan(got[3:]).any()),
                        "K3: a padded row must give 0, ids past V NaN")
    del cases, t
    # the gradient
    g = torch.randn((b, d), generator=gen, device=dev)
    leaf = table.detach().requires_grad_()
    with torch.enable_grad():
        k3.GatherPoolMean.apply(leaf, ids).backward(g)
    want_g, scale = plain_pool_grad(torch, table, ids, g)
    diff = (leaf.grad.double() - want_g).abs()
    bad = int((diff > POOL_GRAD_REL * scale + 1e-7).sum())
    grad_err = float(diff.max())
    require(bad == 0, f"K3 gradient: {bad} entries outside "
                      f"{POOL_GRAD_REL}·Σ|terms| (max err {grad_err:.3g})")
    del leaf, want_g, scale, diff
    log(f"[mesh-kernels] K3 B,K,D={b},{k},{d} sum and mean, and B=8191 "
        f"(a padded row, ids past V), K=1, D=16, D=128 vs plain: max err "
        f"{max(errs):.3g} (tol atol={atol} rtol={rtol}); gradient vs "
        f"autograd through the plain pool (f64): max err {grad_err:.3g} "
        f"(limit {POOL_GRAD_REL}·Σ|terms| + 1e-7); controls: "
        + ", ".join(f"{n} leaves {c} entries outside" for n, c in
                    ctl.items()))
    # times over the id sets of the first batches, as trained
    lib_in = []
    for x in id_sets:
        valid = (x >= 0).float()
        lib_in.append((x.clamp_min(0),
                       valid / valid.sum(1, keepdim=True).clamp_min(1.0)))
    lib = F.embedding_bag(lib_in[0][0], table, mode="sum",
                          per_sample_weights=lib_in[0][1])
    lib_diff = float((lib - want).abs().max())
    n_sets = len(id_sets)
    times = dict(
        ms=device_ms(torch, lambda i: k3.fused_gather_pool(
            table, id_sets[i], "mean"), n_sets, iters=4 * n_sets),
        plain_ms=device_ms(torch, lambda i: k3.fused_gather_pool_plain(
            table, id_sets[i], "mean"), n_sets, iters=n_sets),
        library_ms=device_ms(torch, lambda i: F.embedding_bag(
            lib_in[i][0], table, mode="sum",
            per_sample_weights=lib_in[i][1]), n_sets, iters=4 * n_sets),
        bytes=float(np.mean([x.numel() * 4 + x.shape[0] * d * 4
                             + torch.unique(x[x >= 0]).numel() * d * 4
                             for x in id_sets])),
        flops=b * k * d + b * d)
    times["bound_ms"] = max(times["bytes"] / HBM_BYTES_PER_S,
                            times["flops"] / F32_FLOPS_PER_S) * 1e3
    times["bound_by"] = ("bytes" if times["bytes"] / HBM_BYTES_PER_S
                         >= times["flops"] / F32_FLOPS_PER_S
                         else "operations")
    log(f"[mesh-kernels] K3 mean device ms per call over {n_sets} batches' "
        f"ids: kernel {times['ms']:.5f}, plain {times['plain_ms']:.5f}, "
        f"embedding_bag {times['library_ms']:.5f} (max diff from the plain "
        f"version {lib_diff:.3g}), bound {times['bound_ms']:.5f} "
        f"({times['bytes']:.0f} B, {times['flops']} flop, "
        f"{times['bound_by']})")
    return max(errs), ctl, times


def mesh_plain_scores(torch, ranker, sample, bids):
    """Click probabilities of the mean-pool ranker on `sample` with
    behavior ids `bids`, through the plain versions of K3 and K1 on the
    card, in predict's batches."""
    from goctr_tpu_torch.ops.kernels.embedding_lookup import (
        fused_gather_pool_plain)
    from goctr_tpu_torch.ops.kernels.row_gather import gather_rows_plain

    out = []
    for s in range(0, sample.rows, MESH_PREDICT_BATCH):
        sl = slice(s, s + MESH_PREDICT_BATCH)
        batch = device_batch(torch, sample, sl, ranker.table.device)
        b = torch.from_numpy(np.ascontiguousarray(bids[sl])).to(
            ranker.table.device)
        pooled = fused_gather_pool_plain(ranker.table, b, "mean")
        item = gather_rows_plain(ranker.table, batch.item_ids)
        logits = ranker.model._tower(batch.user_profile, pooled, item,
                                     batch.ctx)
        out.append(torch.sigmoid(logits).cpu().numpy())
    return np.concatenate(out)


def check_mesh_predict(torch, ranker, counted):
    """The trained mean-pool ranker's predict on held-out rows (batch
    MESH_PREDICT_BATCH) through K3, counts reset just before and read
    just after; scores against the plain path within SCORE_ATOL_TRAINED,
    and controls (behavior ids shifted by one, no behaviors: a zeroed
    pool) through the plain path that must exceed it."""
    cfg = ranker.model
    test = make_workload(MESH_PREDICT_ROWS, cfg.item_vocab, cfg.behavior_len,
                         cfg.u_profile_dim, cfg.ctx_dim, seed=SEED + 5)
    for f in counted.values():
        f.launches = 0
    t0 = time.perf_counter()
    got = ranker.predict(test, batch_size=MESH_PREDICT_BATCH)
    dt = time.perf_counter() - t0
    launches = counted["fused_gather_pool"].launches
    require(launches > 0, "mesh predict: K3 was never launched")
    require(got.shape == (test.rows,) and np.isfinite(got).all()
            and ((got >= 0) & (got <= 1)).all(),
            "mesh predict: scores not finite probabilities")
    err = float(np.abs(got - mesh_plain_scores(
        torch, ranker, test, test.behavior_ids)).max())
    require(err <= SCORE_ATOL_TRAINED,
            f"mesh predict: kernels vs plain max |diff| {err:.3g}")
    v = cfg.item_vocab
    bids = test.behavior_ids
    ctl = {}
    for name, b in (("behavior rows shifted",
                     np.where(bids >= 0, (bids + 1) % v, -1).astype(
                         np.int32)),
                    ("pool zeroed", np.full_like(bids, -1))):
        ctl[name] = float(np.abs(got - mesh_plain_scores(
            torch, ranker, test, b)).max())
        require(ctl[name] > SCORE_ATOL_TRAINED,
                f"mesh predict control '{name}': {ctl[name]:.3g} is inside "
                f"the limit {SCORE_ATOL_TRAINED}")
    log(f"[mesh] predict {test.rows} held-out rows at batch "
        f"{MESH_PREDICT_BATCH} in {dt * 1e3:.1f} ms (K3 launches "
        f"{launches}): kernels vs plain max |score diff| {err:.3g} (tol "
        f"{SCORE_ATOL_TRAINED}); controls (must exceed it): "
        + ", ".join(f"{k} {x:.3g}" for k, x in ctl.items()))
    return launches, err, ctl


def profile_dense_step(torch, result, sample, cfg, mesh):
    """profile_steps over the dense step on a copy of the trained result,
    the device time grouped into K3, K1, the backward scatter
    (index_add_), the tower's matmuls and the rest; and the solver's pass
    alone (one adam update of every leaf, table included, and the adds)."""
    import copy

    from goctr_tpu_torch.parallel import scanned as sc
    from goctr_tpu_torch.parallel import train as tr

    model = copy.deepcopy(result.model)
    table = result.table.clone()
    state = [x.clone() for x in result.opt_state]
    solver = sc.make_trainer_solver(cfg)
    step_fn = tr.make_sharded_train_step(model, solver, mesh)
    bs = cfg.batch_size
    batches = [device_batch(torch, sample, slice(b * bs, (b + 1) * bs),
                            table.device) for b in range(4)]

    def step(i):
        nonlocal state
        _, state = step_fn(table, state, batches[i % 4])

    prof = profile_steps(torch, step, "mesh-profile")
    groups = {"K3 gather_pool": ("gather_pool_kernel",),
              "K1 row_gather": ("row_gather_kernel",),
              "backward scatter (index_add_)": ("indexFuncLargeIndex",
                                                "index_add"),
              "tower matmuls": ("gemm", "xmma", "cutlass", "sm90_")}
    by = dict.fromkeys(list(groups) + ["other"], 0.0)
    for us, _, key in prof["rows"]:
        name = next((g for g, pats in groups.items()
                     if any(p in key for p in pats)), "other")
        by[name] += us / prof["steps"] / 1e3
    leaves = tr.dense_path_leaves(model, table)
    zeros = [torch.zeros_like(p) for p in leaves]

    def solve(i):
        upd, _ = solver.update(zeros, state, leaves)
        for p, u in zip(leaves, upd):
            p.add_(u)

    solver_ms = device_ms(torch, solve, 1, iters=4)
    log("[mesh-profile] dense step device ms by part: "
        + ", ".join(f"{k} {x:.4f}" for k, x in by.items())
        + f"; the solver's pass alone (adam over every leaf, table "
        f"included, and the adds) {solver_ms:.4f}")
    return dict(prof, parts=by, solver_ms=solver_ms)


def small_mesh_check(torch, dev, mesh):
    """Small f32 trainers (tanh tower, table adagrad lr 0.05) on the card
    (kernels) against the port on the CPU (plain versions), 3 shuffled
    epochs from the same start: the dense path with mean and DIN pooling, the sparse path in fused (split
    at D = 8, K5 / K6 at D = 64 / 8), fused2, runfused and dedup at D = 8
    and D = 64."""
    from goctr_tpu_torch.core.meshes import single_device_mesh
    from goctr_tpu_torch.models.trainer import TrainerConfig
    from goctr_tpu_torch.parallel.scanned import TableOptConfig
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
    from goctr_tpu_torch.parallel.sparse_trainer import (
        SparseSample, TrainedSparseRanker, train_sparse)

    rng = np.random.default_rng(SEED + 7)
    n, vocab = 2500, 400
    sample = SparseSample(
        user_profile=rng.random((n, 4)).astype(np.float32),
        behavior_ids=rng.integers(-1, vocab, (n, 5)).astype(np.int32),
        item_ids=rng.integers(0, vocab, n).astype(np.int32),
        ctx=rng.random((n, 2)).astype(np.float32),
        labels=(rng.random(n) > 0.5).astype(np.float32))
    cpu = single_device_mesh("cpu")
    # a tanh tower, the main path's adam lr 1e-3 and table adagrad lr
    # 0.05: a relu unit whose pre-activation lies within f32 rounding of 0
    # for one row takes that row's gradient on one device and drops it on
    # the other, and adam and adagrad scale each step by the gradient's
    # own size; at D = 8 a row's first adagrad step is lr/√8 an entry, and
    # at lr 0.3 the card's other order of f32 sums (stage 3's cumsum
    # differences among them) grew to 3e-5 in 3 epochs. On an H100: 8.3e-3
    # (relu, adam lr 1e-2), 4e-5 (relu, 1e-3), 3.03e-5 (tanh, 1e-3, table
    # lr 0.3, D = 8). A wrong line or row still moves entries by ~lr/√D.
    cfg = TrainerConfig(batch_size=1024, epochs=3, early_stop=0, lr=1e-3,
                        seed=SEED)
    cases = [(64, "mean", None), (64, "din_attention", None)]
    for dd in (8, 64):
        cases += [(dd, "din_attention", dict(update_mode="fused",
                                             rmw_impl="kernel")),
                  (dd, "din_attention", dict(update_mode="fused2")),
                  (dd, "mean", dict(update_mode="runfused")),
                  (dd, "din_attention", dict(update_mode="dedup"))]
    cases.append((8, "din_attention", dict(update_mode="fused")))
    worst = [0.0, 0.0]
    for dd, pooling, change in cases:
        mc = dict(item_vocab=vocab, emb_dim=dd, u_profile_dim=4, ctx_dim=2,
                  behavior_len=5, hidden=(16,), pooling=pooling,
                  activation="tanh")
        m0 = SparseCTR(**mc, device="cpu")
        start = TrainedSparseRanker(
            model=m0, table=m0.init_params(torch.Generator().manual_seed(
                SEED)), mesh=cpu, loss_curve=[])
        topt = (None if change is None
                else TableOptConfig(kind="adagrad", lr=0.05, **change))
        c, g = (train_sparse(SparseCTR(**mc, device=m.device), sample, m,
                             cfg, table_opt=topt, resume_from=start)
                for m in (cpu, mesh))
        what = f"small mesh trainer D={dd} {pooling} {change or 'dense'}"
        lc = np.abs(np.array(g.loss_curve) - c.loss_curve) / np.abs(
            c.loss_curve)
        worst[0] = max(worst[0], float(lc.max()))
        require(lc.max() <= TRAJ_LOSS_RTOL,
                f"{what}: loss curves differ by {lc.max():.3g}")
        pairs = [("table", g.table, c.table)]
        if c.acc is not None:
            pairs.append(("acc", g.acc, c.acc))
        for name, x, y in pairs:
            bad, err = within(torch, x.cpu(), y, TRAJ_TABLE_RTOL,
                              TRAJ_TABLE_ATOL)
            worst[1] = max(worst[1], err)
            require(bad == 0, f"{what}: {name} {bad} entries outside (max "
                              f"err {err:.3g})")
    log(f"[mesh] small f32 mesh trainers, card (kernels) vs CPU (plain), "
        f"{len(cases)} configurations (dense mean and DIN; fused, fused2, "
        f"runfused, dedup at D = 8 and 64), 3 epochs: max loss rel diff "
        f"{worst[0]:.3g} (rtol {TRAJ_LOSS_RTOL}), max table/acc err "
        f"{worst[1]:.3g} (rtol {TRAJ_TABLE_RTOL}, atol {TRAJ_TABLE_ATOL})")


def sparse_mesh_path(torch, dev, gen, mesh, sample, counted):
    """The sparse path at full width: headline DIN, table adagrad lr
    TABLE_LR, update_mode fused, shuffle off; one epoch each with the
    split row update (K1 read + K4) and with K5, from the same start as
    one train_sparse_scanned split/xla epoch, whose first-epoch loss they
    must match within MESH_LOSS_RTOL; a control (stage 4 writing each run
    to the next id's line) must exceed it. Then one epoch of the 100M ×
    16 grouped-resident lines through the mesh step with K6. Counts reset
    just before, read just after."""
    import dataclasses

    from goctr_tpu_torch.models.trainer import TrainerConfig
    from goctr_tpu_torch.parallel import scanned as sc
    from goctr_tpu_torch.parallel import train as tr
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
    from goctr_tpu_torch.parallel.sparse_trainer import (
        TrainedSparseRanker, train_sparse)

    cfg = TrainerConfig(batch_size=TRAIN_BATCH, epochs=1, early_stop=0,
                        lr=1e-3, shuffle=False, seed=SEED)
    model0 = SparseCTR(**HEADLINE, compute_dtype=torch.bfloat16, device=dev)
    table0 = model0.init_params(gen)
    scan = sc.train_sparse_scanned(
        SparseCTR(**HEADLINE, compute_dtype=torch.bfloat16, device=dev),
        sample, cfg, sc.TableOptConfig(
            kind="adagrad", lr=TABLE_LR,
            compact_cap=bench_compact_cap(sample, TRAIN_BATCH)),
        resume_from=sc.TrainedScanned(model=model0, table=table0,
                                      loss_curve=[]), device=dev)
    require(scan.update_overflow_max == 0, "mesh: scanned run overflowed")
    loss0, t0 = scan.loss_curve[0], scan.epoch_times[0]
    del scan
    start = TrainedSparseRanker(model=model0, table=table0, mesh=mesh,
                                loss_curve=[])
    topt = sc.TableOptConfig(kind="adagrad", lr=TABLE_LR)
    for f in counted.values():
        f.launches = 0

    def run(rmw, sample=sample, model_cfg=HEADLINE, resume=start):
        r = train_sparse(
            SparseCTR(**model_cfg, compute_dtype=torch.bfloat16, device=dev),
            sample, mesh, cfg, table_opt=dataclasses.replace(
                topt, rmw_impl=rmw), resume_from=resume)
        require(r.lookup_overflow_max == 0 and np.isfinite(r.loss_curve[0]),
                f"mesh sparse {rmw}: overflow or a non-finite loss")
        return r

    out = {}
    for rmw in ("split", "kernel"):
        r = run(rmw)
        require(tuple(r.table.shape) == (HEADLINE["item_vocab"],
                                         HEADLINE["emb_dim"]),
                "mesh sparse: the result is not the [V, D] table")
        out[rmw] = (r.loss_curve[0], r.epoch_times[0],
                    abs(r.loss_curve[0] - loss0) / abs(loss0))
        del r
    launches = {k: f.launches for k, f in counted.items()}
    path = ("gather_rows", "din_attention_pool", "din_attention_pool_bwd",
            "scatter_rows_packed", "apply_row_updates")
    require(all(launches[k] > 0 for k in path),
            f"mesh sparse: a kernel of the path was never launched "
            f"{launches}")
    for rmw, (loss, _, rel) in out.items():
        require(rel <= MESH_LOSS_RTOL,
                f"mesh sparse {rmw}: first-epoch loss {loss} vs scanned "
                f"{loss0} (rel {rel:.3g} > {MESH_LOSS_RTOL})")
    real = tr.apply_row_updates_split
    try:
        tr.apply_row_updates_split = (
            lambda table, ids, upd, skip_ge, real=real, **kw: real(
                table, torch.where(ids < skip_ge, ids + 1, ids), upd,
                skip_ge=skip_ge, **kw))
        r = run("split")
    finally:
        tr.apply_row_updates_split = real
    ctl = abs(r.loss_curve[0] - loss0) / abs(loss0)
    del r, start, table0
    require(ctl > MESH_LOSS_RTOL,
            f"mesh sparse control: loss rel diff {ctl:.3g} is inside the "
            f"limit {MESH_LOSS_RTOL}")
    log(f"[mesh] sparse path, headline DIN, one epoch each from one start "
        f"(shuffle off): scanned split/xla {loss0} ({t0:.3f} s); mesh "
        + "; ".join(f"{rmw} {x[0]} (rel diff {x[2]:.3g}, {x[1]:.3f} s)"
                    for rmw, x in out.items())
        + f" (limit {MESH_LOSS_RTOL}); control, stage 4 writing each run to "
        f"the next id's line: rel diff {ctl:.3g}; launches {launches}")
    # the 100M x 16 grouped-resident lines through the mesh step (K6)
    g_sample = make_workload(GROUPED_TRAIN_ROWS, GROUPED["item_vocab"],
                             GROUPED["behavior_len"],
                             GROUPED["u_profile_dim"], GROUPED["ctx_dim"],
                             seed=SEED)
    for f in counted.values():
        f.launches = 0
    r = run("kernel", sample=g_sample, model_cfg=GROUPED, resume=None)
    g_launches = {k: f.launches for k, f in counted.items()}
    require(r.packed_group == 7 and g_launches["apply_line_updates"] > 0,
            f"mesh grouped: not the resident lines through K6 "
            f"{g_launches}")
    log(f"[mesh] grouped-resident 100M x 16 lines {tuple(r.table.shape)}, "
        f"one epoch through the mesh step with K6: loss {r.loss_curve[0]} "
        f"in {r.epoch_times[0]:.3f} s; launches {g_launches}")
    del r
    return ctl


def mesh_phase(torch, dev, gen):
    """Phase 8: the mesh trainer train_sparse on the 1×1 mesh. K3 checked
    and timed on the dense path's own inputs; the main path — the dense
    path at full width (headline widths, mean pooling, batch TRAIN_BATCH,
    adam lr 1e-3 and l2 0 on every leaf, table included, TRAIN_EPOCHS
    shuffled epochs) with counts reset just before and read just after,
    and the trained ranker's predict; a profiled dense step; the sparse
    path (sparse_mesh_path); small f32 trainers card vs CPU. Returns the
    kernels-line entry of K3."""
    from goctr_tpu_torch.core.meshes import single_device_mesh
    from goctr_tpu_torch.models.trainer import TrainerConfig
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
    from goctr_tpu_torch.parallel.sparse_trainer import (
        TrainedSparseRanker, train_sparse)

    t_phase = time.perf_counter()
    mesh = single_device_mesh(dev)
    V, T = HEADLINE["item_vocab"], HEADLINE["behavior_len"]
    sample = make_workload(TRAIN_ROWS, V, T, HEADLINE["u_profile_dim"],
                           HEADLINE["ctx_dim"], seed=SEED)
    mean_cfg = dict(HEADLINE, pooling="mean")
    cfg = TrainerConfig(batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS,
                        early_stop=0, lr=1e-3, l2=0.0, shuffle=True,
                        seed=SEED)
    model0 = SparseCTR(**mean_cfg, compute_dtype=torch.bfloat16, device=dev)
    table0 = model0.init_params(gen)
    # the behavior ids of the dense path's first batches, as it shuffles
    order = np.random.default_rng(cfg.seed).permutation(sample.rows)
    id_sets = [torch.from_numpy(np.ascontiguousarray(sample.behavior_ids[
        order[b * TRAIN_BATCH:(b + 1) * TRAIN_BATCH]])).to(dev)
        for b in range(4)]
    k3_err, ctl, times = check_gather_pool(torch, table0, id_sets)
    del id_sets
    torch.cuda.empty_cache()

    # the main path: counts reset just before, read just after
    counted = counted_kernels()
    for f in counted.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    r = train_sparse(
        SparseCTR(**mean_cfg, compute_dtype=torch.bfloat16, device=dev),
        sample, mesh, cfg,
        resume_from=TrainedSparseRanker(model=model0, table=table0,
                                        mesh=mesh, loss_curve=[]))
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counted.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    del table0
    require(launches["fused_gather_pool"] > 0 and launches["gather_rows"] > 0,
            f"mesh dense: a kernel of the path was never launched {launches}")
    lc = r.loss_curve
    require(all(np.isfinite(lc)) and lc[-1] < lc[0],
            f"mesh dense: the loss does not fall {lc}")
    steps = -(-TRAIN_ROWS // TRAIN_BATCH)
    steady = TRAIN_ROWS * (TRAIN_EPOCHS - 1) / sum(r.epoch_times[1:])
    log(f"[mesh] dense path, headline widths with mean pooling, V={V} D="
        f"{HEADLINE['emb_dim']}, batch {TRAIN_BATCH}, {steps} steps/epoch: "
        f"loss curve {lc}, epoch s {r.epoch_times}; steady-state "
        f"{steady:.1f} ex/s, step "
        f"{sum(r.epoch_times[1:]) / (steps * (TRAIN_EPOCHS - 1)) * 1e3:.3f}"
        f" ms; peak device memory {peak:.2f} GB; launches {launches}")
    k3_pred, pred_err, pred_ctl = check_mesh_predict(torch, r, counted)
    ctl.update(pred_ctl)
    prof = profile_dense_step(torch, r, sample, cfg, mesh)
    del r
    torch.cuda.empty_cache()
    ctl["mesh sparse next id"] = sparse_mesh_path(torch, dev, gen, mesh,
                                                  sample, counted)
    torch.cuda.empty_cache()
    small_mesh_check(torch, dev, mesh)
    log(f"[mesh] done in {time.perf_counter() - t_phase:.1f} s: dense "
        f"steady {steady:.1f} ex/s, profiled step device busy "
        f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f}; K3 launches "
        f"{launches['fused_gather_pool']} training + {k3_pred} predict; "
        f"controls {ctl}")
    return {"name": "gather_pool", "route": "cuda",
            "source": "goctr_tpu_torch/csrc/gather_pool.cu",
            "replaces": "goctr_tpu/ops/pallas/embedding_lookup.py:106",
            "launches": launches["fused_gather_pool"] + k3_pred,
            "max_abs_err": k3_err, "ms": times["ms"],
            "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
            "bound_by": times["bound_by"],
            "library_ms": times["library_ms"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from goctr_tpu_torch.ops.kernels import _build
    from goctr_tpu_torch.ops.kernels import din_attention as k2
    from goctr_tpu_torch.ops.kernels import row_gather as k1
    from goctr_tpu_torch.ops.kernels.row_optimizer import (
        group_size, pack_table)
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
    from goctr_tpu_torch.serve.scorer import DeviceScorer

    torch.set_grad_enabled(False)       # serving only: no autograd graphs
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kernels = (k1.gather_rows, k2.din_attention_pool)

    # 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build("row_gather", "din_attention", "din_attention_bwd",
                        "row_scatter", "compact_runsums", "row_rmw",
                        "csum_rmw", "run_rmw", "gather_pool")
    card = card_line()
    log(f"[build] {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; card: {card}")

    # headline model, table and requests -----------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = SparseCTR(**HEADLINE, compute_dtype=torch.bfloat16, device=dev)
    table = model.init_params(gen)                     # [10M, 64] f32
    rng = np.random.default_rng(SEED)
    reqs = make_requests(rng, R_REQ * (TIMED_BATCHES + 1),
                         HEADLINE["item_vocab"], HEADLINE)
    scorer = DeviceScorer(model, table, device=dev)
    V, D, T = HEADLINE["item_vocab"], HEADLINE["emb_dim"], \
        HEADLINE["behavior_len"]

    # 2. kernels vs plain, at the path's shapes ----------------------------
    prof0, bids0, ctx0, cands0 = batch(reqs, 0)
    K = 512                                            # bucket of 400
    # K1 and K2 on the path's own inputs: the ids and rows of batch 0
    path_ids, eb, item, mask = path_inputs(torch, scorer, bids0, cands0, K)
    packed = pack_table(table)                         # [10M, 128] f32
    k1_err = max(check_gather(torch, k1, table, path_ids, 1, D, V, "plain"),
                 check_gather(torch, k1, packed, path_ids, 1, D, V,
                              "packed"))
    att0 = model.att0.detach()
    k2_err = check_din(torch, k2, eb, item, att0, mask, "headline")
    check_din(torch, k2, eb.float(), item.float(), att0, mask,
              "headline f32")
    drng = np.random.default_rng(SEED + 2)
    for dt_ in (torch.float32, torch.bfloat16):
        check_din(torch, k2, *din_inputs(torch, drng, 1024, 512, 64, dt_,
                                         dev, lengths=True),
                  "T=512, ragged lengths")
        check_din(torch, k2, *din_inputs(torch, drng, 1024, 500, 64, dt_,
                                         dev), "ragged T=500")
        check_din(torch, k2, *din_inputs(torch, drng, 4096, 32, 16, dt_,
                                         dev), "D=16")
    n_ids = path_ids.numel()
    ids_by_batch = [torch.from_numpy(np.concatenate(
        [b.reshape(-1).clip(0)] + [np.pad(c, (0, K - len(c)))
                                   for c in cs])).to(dev)
        for _, b, _, cs in (batch(reqs, i)
                            for i in range(TIMED_BATCHES + 1))]
    n_sets = len(ids_by_batch)             # other rows each call, as served
    gather_ms = device_ms(torch, lambda i: k1.gather_rows(
        table, ids_by_batch[i], dim=D, out_dtype=torch.bfloat16), n_sets,
        iters=n_sets)
    gather_call_ms = cuda_ms(torch, lambda: k1.gather_rows(
        table, path_ids, dim=D, out_dtype=torch.bfloat16), iters=50)
    gather_plain_ms = device_ms(torch, lambda i: k1.gather_rows_plain(
        table, ids_by_batch[i], dim=D, out_dtype=torch.bfloat16), n_sets,
        iters=n_sets)
    gather_lib_ms = device_ms(torch, lambda i: torch.index_select(
        table, 0, ids_by_batch[i]), n_sets, iters=n_sets)
    gather_packed_ms = device_ms(torch, lambda i: k1.gather_rows(
        packed, ids_by_batch[i], dim=D, out_dtype=torch.bfloat16), n_sets,
        iters=n_sets)
    # bytes the gather must move: ids and output once each, and each
    # distinct row once (zipf ids repeat), averaged over the timed id sets
    gather_bytes = float(np.mean([
        x.numel() * (4 + D * 2) + torch.unique(x).numel() * D * 4
        for x in ids_by_batch]))
    din_ms = device_ms(torch, lambda i: k2.din_attention_pool(
        eb, item, att0, mask), 1)
    din_call_ms = cuda_ms(torch, lambda: k2.din_attention_pool(
        eb, item, att0, mask))
    din_plain_ms = device_ms(torch, lambda i: k2.din_attention_pool_plain(
        eb, item, att0, mask), 1)
    B = eb.shape[0]
    din_bytes = B * T * D * 2 + B * D * 2 + T * 4 + B * T * 4 + B * D * 2
    din_flops = B * T * (6 * D + 12)
    din_bound_ms = max(din_bytes / HBM_BYTES_PER_S,
                       din_flops / F32_FLOPS_PER_S) * 1e3
    log(f"[kernels] K1 n={n_ids} D={D} bf16 out, device ms per call: kernel "
        f"{gather_ms:.5f} (packed table {gather_packed_ms:.5f}), plain "
        f"{gather_plain_ms:.5f}, index_select {gather_lib_ms:.5f}, bound "
        f"{gather_bytes / HBM_BYTES_PER_S * 1e3:.5f} ({gather_bytes:.0f} B); "
        f"wrapper call incl. host {gather_call_ms:.5f}")
    log(f"[kernels] K2 B={B} T={T} D={D} bf16, device ms per call: kernel "
        f"{din_ms:.5f}, plain {din_plain_ms:.5f}, bound {din_bound_ms:.5f} "
        f"({din_bytes} B, {din_flops} flop); wrapper call incl. host "
        f"{din_call_ms:.5f}")
    del eb, item, mask

    # 3. headline serving -------------------------------------------------
    small_f32_check(torch, dev)
    first, rate_plain, launches = drive(torch, kernels, scorer, reqs,
                                        "headline plain [10M,64]")
    err_plain = check_scores(first, plain_scores(torch, scorer, prof0, bids0,
                                                 ctx0, cands0),
                             SCORE_ATOL_BF16, "headline kernels vs plain")
    ctl = check_controls(torch, scorer, first, prof0, bids0, ctx0, cands0,
                         "headline")
    scorer_packed = DeviceScorer(model, packed, table_packed=True,
                                 device=dev)
    first_p, rate_packed, _ = drive(torch, kernels, scorer_packed, reqs,
                                    "headline packed [10M,128]")
    check_scores(first_p, first, SCORE_ATOL_BF16, "packed vs plain layout")
    profile_batch(torch, scorer, reqs)
    del scorer_packed, packed

    # 4. grouped 100M x 16 ------------------------------------------------
    g_model = SparseCTR(**GROUPED, compute_dtype=torch.bfloat16, device=dev)
    G = group_size(GROUPED["emb_dim"])
    lines = g_model.init_params(gen, table_group=G)
    log(f"[grouped] lines {tuple(lines.shape)} f32 "
        f"({lines.numel() * 4 / 1e9:.2f} GB), G={G}")
    g_scorer = DeviceScorer(g_model, lines, packed_group=G, device=dev)
    g_reqs = make_requests(np.random.default_rng(SEED + 3),
                           R_REQ * (TIMED_BATCHES + 1),
                           GROUPED["item_vocab"], GROUPED)
    gp, gb, gc, gk = batch(g_reqs, 0)
    g_ids, g_eb, g_item, g_mask = path_inputs(torch, g_scorer, gb, gk, K)
    k1_err = max(k1_err, check_gather(torch, k1, lines, g_ids, G,
                                      GROUPED["emb_dim"], lines.shape[0] * G,
                                      "grouped"))
    k2_err = max(k2_err, check_din(torch, k2, g_eb, g_item,
                                   g_model.att0.detach(), g_mask, "grouped"))
    del g_eb, g_item, g_mask
    g_first, rate_grouped, g_launches = drive(
        torch, kernels, g_scorer, g_reqs, "grouped [100M,16] G=7")
    check_scores(g_first, plain_scores(torch, g_scorer, gp, gb, gc, gk),
                 SCORE_ATOL_BF16, "grouped kernels vs plain")
    g_ctl = check_controls(torch, g_scorer, g_first, gp, gb, gc, gk,
                           "grouped")
    del g_scorer, lines

    # 5. http -------------------------------------------------------------
    http_check(scorer, reqs)

    # 6. train ------------------------------------------------------------
    modes = [{"update_mode": m}
             for m in ("fused2", "runfused", "dedup", "sorted", "plain")]
    t6, e6, l6 = train_phase(
        torch, dev, gen, reqs, kernels, "train", HEADLINE, TRAIN_ROWS,
        small_cases=[{"compact_cap": 0}, {"compact_cap": 2048},
                     {"compact_cap": 2048, "compact_impl": "kernel"},
                     {"compact_cap": 2048, "rmw_impl": "kernel"}, *modes],
        variants=[("kernel compaction", {"compact_impl": "kernel"}),
                  ("K5 row update", {"rmw_impl": "kernel"}),
                  ("K7 fused2", {"update_mode": "fused2"}),
                  ("K8 runfused", {"update_mode": "runfused"}),
                  ("dedup", {"update_mode": "dedup"})],
        controls=(compaction_controls, update_mode_controls),
        pair=(("plain", {"update_mode": "plain"}),
              ("sorted", {"update_mode": "sorted"})))
    torch.cuda.empty_cache()

    # 7. grouped training ---------------------------------------------------
    t7, e7, l7 = train_phase(
        torch, dev, gen, g_reqs, kernels, "grouped-train", GROUPED,
        GROUPED_TRAIN_ROWS,
        small_cases=[{"compact_cap": 2048}, {"rmw_impl": "kernel"},
                     {"compact_cap": 2048, "compact_impl": "kernel",
                      "rmw_impl": "kernel"}, *modes],
        variants=[("one-pass (K6, K9)", {"rmw_impl": "kernel",
                                         "compact_impl": "kernel"})],
        controls=(line_update_controls,))
    torch.cuda.empty_cache()

    # 8. the mesh trainer ---------------------------------------------------
    k3_entry = mesh_phase(torch, dev, gen)
    k1_err = max(k1_err, e6["K1"], e7["K1"])
    k2_err = max(k2_err, e6["K2"], e7["K2"])
    train_entries = []
    for key, name, src, replaces, times, counts, count_name in (
            ("K2b", "din_attention_bwd", "din_attention_bwd.cu",
             "goctr_tpu/parallel/sparse_ctr.py:128", t6, l6,
             "din_attention_pool_bwd"),
            ("K4", "scatter_rows_packed", "row_scatter.cu",
             "goctr_tpu/ops/pallas/row_optimizer.py:824", t6, l6,
             "scatter_rows_packed"),
            ("K9", "compact_runsums_block", "compact_runsums.cu",
             "goctr_tpu/ops/pallas/compact.py:129", t6, l6,
             "compact_runsums_block"),
            ("K5", "row_rmw", "row_rmw.cu",
             "goctr_tpu/ops/pallas/row_optimizer.py:176", t6, l6,
             "apply_row_updates"),
            ("K6", "line_rmw", "row_rmw.cu",
             "goctr_tpu/ops/pallas/row_optimizer.py:699", t7, l7,
             "apply_line_updates"),
            ("K7", "csum_rmw", "csum_rmw.cu",
             "goctr_tpu/ops/pallas/row_optimizer.py:393", t6, l6,
             "apply_csum_updates"),
            ("K8", "run_rmw", "run_rmw.cu",
             "goctr_tpu/ops/pallas/run_optimizer.py:242", t6, l6,
             "apply_run_updates")):
        r = times[key]
        err_key = "K2b d_behaviors" if key == "K2b" else key
        train_entries.append({
            "name": name, "route": "cuda",
            "source": f"goctr_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": counts[count_name],
            "max_abs_err": max(e.get(err_key, 0.0) for e in (e6, e7)),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})

    # result lines -------------------------------------------------------
    kernels_line = {"kernels": [
        {"name": "row_gather", "route": "cuda",
         "source": "goctr_tpu_torch/csrc/row_gather.cu",
         "replaces": "goctr_tpu/ops/pallas/row_gather.py:74",
         "launches": launches["row_gather"], "max_abs_err": k1_err,
         "ms": gather_ms, "plain_ms": gather_plain_ms,
         "bound_ms": gather_bytes / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": gather_lib_ms},
        {"name": "din_attention", "route": "cuda",
         "source": "goctr_tpu_torch/csrc/din_attention.cu",
         "replaces": "goctr_tpu/ops/pallas/din_attention.py:97",
         "launches": launches["din_attention"], "max_abs_err": k2_err,
         "ms": din_ms, "plain_ms": din_plain_ms, "bound_ms": din_bound_ms,
         "bound_by": ("bytes" if din_bytes / HBM_BYTES_PER_S
                      >= din_flops / F32_FLOPS_PER_S else "operations"),
         "library_ms": None},
    ] + train_entries + [k3_entry]}
    log(f"[done] scores/s plain {rate_plain:.1f}, packed {rate_packed:.1f}, "
        f"grouped {rate_grouped:.1f}; grouped launches {g_launches}; "
        f"err plain {err_plain:.3g}; smallest control reading headline "
        f"{min(ctl.values()):.3g}, grouped {min(g_ctl.values()):.3g}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB since phase 8's main path; total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
