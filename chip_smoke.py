#!/usr/bin/env python3
"""Drive goctr_tpu_torch on one NVIDIA card and check it end to end.

    python3 chip_smoke.py            (from the repository root)

Phases, in order; any failure raises and the script exits nonzero:
  1. build   — compile every CUDA kernel of the port from
               goctr_tpu_torch/csrc/ (one nvcc per source, in parallel);
               print each kernel's registers, shared memory and spills
               (ptxas) and the card's name and power limit.
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
               K2b, the "xla" compaction kernel (the main path's front
               end: bit for bit with the glue it replaced), K4, K5, K9,
               K7 and K8 are held against their plain versions on the
               first step's own inputs (K7 and K8 to a limit derived
               from the exact update of each line), with controls that
               must exceed each limit, and timed beside
               their plain versions (K7 and K8 also beside the fused
               path's update of the same stream); wrong compactions and
               K7 / K8 fed a wrong stream (controls) move the first-epoch
               loss past its limit; small f32 models trained on the card
               in every update mode are held against the port on the
               CPU; a profiled step gives the device-time breakdown; the
               trained result scores EVAL_ROWS held-out rows of the same
               draw (eval_auc, eval_gauc and the oracle's
               eval_auc_ceiling, as bench.py reports them) and serves
               through DeviceScorer with the phase-3 score check and
               controls.
  7. grouped training — the 100M × 16 configuration (G = 7 rows per
               128-lane line, 7.3 GB of lines drawn directly) trained at
               batch 65,536 on the JAX bench's 1,000,000-row workload for
               this configuration: 3 epochs with the split line update
               (K1 read, torch, K4) and 1 epoch from the same start with
               the one-pass kernels (K6, K9) — the main path, counts reset
               just before and read just after. K1, K2, K2b, the "xla"
               compaction (its [capr, D] rows), K9, K4 and K6 are held
               against their plain versions on the first step's own
               inputs, with controls; the first-epoch losses agree,
               and K6 writing each update to its neighbour slot's line
               (control) moves that loss past the limit; small grouped
               f32 trainers on the card (grouped lines, and the other
               update modes from lines) are held against the port on the
               CPU; 3 profiled steps; held-out eval as in phase 6; the
               trained lines serve with the score check and controls.
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
               the mesh step (K6); small f32 mesh trainers card vs CPU
               (tanh towers over 3 epochs; relu towers over one step,
               with a control).
  9. dense   — the dense rankers at the JAX package's ML-20M protocol
               widths (281 columns, batch 16,384, adam 1e-3, f16
               storage, bf16 compute) on 2,097,152 planted rows: K2 and
               K2b against their plain versions on the DIN "pallas" run's
               first step (no mask), with controls, and timed; the DIN
               pool at T = 512 through K2 and through the "xla" torch
               ops; small f32 rankers card vs CPU. The main path, counts
               reset just before and read just after: MLPTower,
               YoutubeDNN, DIN "xla" and DIN "pallas" (K2 forward, K2b
               backward) trained 3 epochs each by train_ranker from seed
               0, scored on 262,144 held-out rows with predict_all (K2),
               AUC and GAUC on the card held to numpy and above chance;
               the two DIN impls' first-epoch losses agree, and a pool
               that returns zeros (control) does not; a profiled step.
 10. item2vec — the port's Word2Vec at the JAX package's bench size
               (goctr_tpu_torch.bench_item2vec's corpus and run, as
               `--quality` trains it: ~9.5M words of planted clusters as
               str tokens, 10k vocab; skipgram + hs, dim 16, window 5,
               batch 65,536, 3 iterations; its steady line): words/s and
               pair-updates/s over iterations 2-3, peak device memory,
               the top-5 neighbour purity gate (>= 0.95, numpy oracle)
               with random vectors as its control; the pipeline's own
               train_embedding call (batch 8,192, one iteration); a
               profiled slice of blocks (idle share); the four
               combinations card vs CPU on the same draws, with a
               control; Searcher's top-10 of 1,000 queries against
               numpy; the text format's round trip of the 10k-word map.
               No kernel lies on this path.
 11. mlp     — the sklearn-style MLPs at full width: MLPClassifier((100,),
               relu, adam, alpha 1e-5) on 131,072 of phase 9's planted
               281-column rows, 3 epochs of batch 200, held-out AUC
               > 0.55; one epoch of sgd + Nesterov; full-batch lbfgs,
               bfgs (dense 28,301² inverse Hessian) and cg, 10 iterations
               each, whose losses must fall; MLPRegressor (64, 64) and
               Neural [342, 64, 64, 1] at examples/futuresales.py's
               layouts on 65,536 rows of its planted sales signal, R² > 0;
               small models card vs CPU with a control. No kernel lies
               on this path.
 12. pipeline — the product path of goctr_tpu_torch/main.py: a fixture
               database made by the port at MovieLens-1M's user and movie
               counts (6,040 × 3,706) with 100,000 ratings, seed 7 (~80k
               training rows of 281 columns); main.py's configuration
               (Config() defaults: MLP (100,) relu, adam, batch 200, 20
               epochs, bf16) through Train on the card — seconds of
               pre_train, item2vec, assembly and the fit, peak memory,
               held-out AUC (> 0.75) and GAUC of BatchPredict over
               ratings_test, card vs CPU scores with a control; the same
               pipeline with DIN "pallas" for 3 epochs, the main path of K2
               (fit forward, BatchPredict, Rank) and K2b (fit backward):
               counts reset just before and read just after, K2 held
               against its plain version on the Rank path's own inputs and
               K2/K2b on the fit's first step, with controls, and timed;
               RecApiServer on the MLP predictor (no rank_direct: Rank)
               answering 16 concurrent clients × 25 requests of 100
               candidates (p50/p99), the dashboard's endpoints and page, a
               BatchPredict of 100 candidates broken down (SQL fetch,
               assembly, copies, device time, idle share);
               `python -m goctr_tpu_torch.main` as a subprocess until it
               answers one POST; and goctr_tpu_torch.bench_serving at its
               defaults (its own fixture, 50 requests × 400 items from 4
               threads over HTTP: the `[bench-serving]` lines).
 13. ml20m   — the ML-20M-statistics protocol through
               scripts/parity_ml20m_torch.py's stages: the port's
               generator at scale 0.05 (6,924 users × 1,337 movies, ~1.1M
               ratings) with PARITY_ML20M_r05_scale01.json's knobs;
               seconds of generation, pre_train, item2vec (on the card),
               assembly (rows/s: 720,000 × 281) and the test slice's
               assembly; MLP, YouTube-DNN and DIN "pallas" by RankerFitter
               (3 epochs, batch 16,384, f16 storage, bf16, relu towers):
               examples/s, ms a step, peak memory, held-out AUC and GAUC on
               the card, each AUC above JAX's lowest CPU reading of the
               same configuration over seeds 0-4 less 0.02 (control: DIN's
               scores against shuffled labels must not clear it); K2 /
               K2b launches reset
               before the DIN fit and read after its predict, both held
               against their plain versions on the fit's first step with
               phase 9's limits and controls, and timed; a profiled DIN
               step (idle share).
 14. mesh ranks — the (data, model) mesh on one card: ranks that share
               cuda:0 over gloo (core/meshes.py `launch`; every
               collective staged through pinned host memory). After the
               1×1 references of the same starts (in this process, the
               cache freed after each), 4 ranks on 2×2: (a) the headline
               through train_sparse (fused, table adagrad) with the split
               update and with K5, 3 steps of 65,536 an epoch (32,768 a
               data shard), 2 epochs, and a control (stage 4 writing each
               run one row on); (c) the dense path with mean pooling, adam
               on every leaf, the table shard included (K3 "sum" on the
               locally masked ids), at the headline widths over a 1M
               vocab; then 2 ranks on 1×2: (b) the 100M × 16 resident
               lines, one epoch with K6 (each rank's lines against JAX's
               3.7 GB a device). Each loss curve within MESH_RANKS_LOSS_
               RTOL of its 1×1 run, the control outside; in each rank the
               launch counts reset just before its run and read just
               after, K1, K3, K5 and K6 held against their plain versions
               on the rank's own inputs (captured on their first call)
               and timed one rank at a time, peak memory. NCCL round-trips
               all_reduce and all_gather at world size 1; with two or more
               cards (a) runs one rank a card over NCCL, else a line says
               why not. Then one `[rmw-share]` line a kernel for K5 and
               K6: the share of real slots in its stream, its time, bound
               and share of the bound on the scanned trainer's first step
               (phases 6, 7) and on each rank's stage-4 stream.
 15. sync    — one step of each training path that promises never to
               make the host wait on the card (parallel/step_cases.py:
               the scanned trainer in every update mode with its kernel
               variants, the 1×1 mesh's sparse step in fused with K5,
               dedup, sorted and plain, its dense step with K3, the four
               dense rankers' steps (DIN "pallas" with K2 / K2b), the
               capped lookup's _dedup_flat) at the headline widths and
               batch, run again under torch.cuda.set_sync_debug_mode(
               "error"): any wait raises. One `[sync]` line names every
               case that passed.
 16. depth   — the headline and BASELINE #5 trained as the JAX bench
               trains them, at its own depth, on fresh tables after the
               earlier phases' are freed (`depth_run`: goctr_tpu_torch.
               bench's `train` at its default flags and at BASELINE #5's):
               bench.py's draw
               of rows + 250,000 held-out rows (bit for bit bench.py's
               rows, dropped after the run), the headline at
               5,000,000 rows, batch 65,536, 4 epochs (77 steps an
               epoch) and the 100M × 16 grouped lines at 1,000,000 rows,
               batch 16,384, 3 epochs (62 steps), fused with the split
               update, xla compaction and bench.py's compact_cap rule.
               Launch counts reset just before each run and read just
               after: K1, K2, K2b, K4 and the "xla" compaction launched,
               K5-K9 not. Each held-out eval_auc (and the headline's
               eval_gauc) must clear JAX's reading of the same draw less
               0.01 (DEPTH_BARS), the oracle's ceiling must round to
               bench.py's, device metrics agree with numpy and the
               scores against permuted held-out labels read chance. The
               headline's run then gives goctr_tpu_torch.bench's JSON
               line (`[bench]`: its serving rates measured on the trained
               model, MFU and HBM use on the card's peaks), held to
               bench.py's keys, finite values, both rates above 0 and
               MFU and HBM use in (0, 100], and one DeviceScorer batch of
               its requests held to predict on the same rows
               (SCORE_ATOL_TRAINED; control: the candidates one place
               on).
 17. bench-kernels — goctr_tpu_torch.bench_kernels (the JAX repository's
               scripts/bench_kernels.py on the port) at the JAX script's
               default shapes and reps: din, gather, scatter, fused,
               segsum, stages and rowgather, then stages --parts; each
               kernel row (K1, K2, K3, K5) held against its plain row,
               launch counts reset just before and read just after (K1,
               K2, K3, K4, K5 launched); then goctr_tpu_torch.
               profile_assembly on phase 13's fixture (made again at its
               knobs), item2vec on the card, over its 720,000 training
               rows: the JAX script's stage lines and rows/s
               (`[assembly]`), the matrix finite at the protocol's width.
Phases 6 and 7 also time K1 (its forward gather and the split update's
read, each with its own bound and main-path launch count) and K2 on the
first step's own inputs. Then it prints the card line, the `kernels`
JSON line (the ten kernels; K1 at the serving shape, at the headline and
grouped forward gathers and at the row-update read; K2 at the serving
and at the headline training shape; K2 and K2b at the dense DIN's
shape at the pipeline DIN's and at the ML-20M DIN's; K1, K3 "sum", K5
and K6 of phase 14, one entry a rank) and, last,
{"ok": true, "device": {...}}.

Exits nonzero when no CUDA device is available.
"""
from __future__ import annotations

import contextlib
import functools
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from goctr_tpu_torch import (
    bench, bench_item2vec, bench_kernels, bench_serving, profile_assembly)
from goctr_tpu_torch.bench import (
    _zipf_ranks, bench_compact_cap, card_line, counted_kernels)
from goctr_tpu_torch.bench_kernels import TOL
from goctr_tpu_torch.utils import timing
from goctr_tpu_torch.utils.timing import device_events, kernel_name

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
# kernel vs plain tolerances, TOL (goctr_tpu_torch.bench_kernels, which
# holds its kernel rows to them too): f32 (1e-6, 1e-5), bf16 output
# (1e-6, 8e-3) as (ATOL, RTOL) of |got - want| <= ATOL + RTOL·|want|
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
# grouped training: BASELINE #5's rows (bench.py:146-147) at the headline's
# batch, not its configuration (batch 16,384: phase 16)
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
# the "xla" compaction's packed ‖Σg‖² lane: summed in f64 and rounded once
# by the kernel, in f32 by PyTorch's reduction in the plain version
XLA_NSQ_RTOL = 1e-6
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
# held-out rows of the SparseCTR training phases (bench.py draws 250,000)
EVAL_ROWS = 262_144
# phase 9, the dense rankers at the JAX package's ML-20M protocol widths
# (scripts/parity_ml20m.py:232-243; row layout recommend/rcmd.py:232-240):
# profile 2 + 5 genres × 10, 10 behaviors × 16, item 16, ctx the 53 raw
# item features; rows cut from 14.4M, epochs from 30
ML20M = dict(u_profile_dim=52, behavior_len=10, behavior_dim=16,
             i_feature_dim=16, c_feature_dim=53)
DENSE_BATCH = 16_384
DENSE_ROWS = 128 * DENSE_BATCH
DENSE_EPOCHS = 3
# the planted rule's positive rate at tests/test_models.py's widths
# (round(0.6·(d1 + d2)) there); at these widths the same rule would give
# 0.8%, so the label is 1 for this share of the rows with the largest d1+d2
DENSE_POS_RATE = 0.1175
LABEL_FLIP = 0.15                  # bench.py's noisy workload
# a trained dense ranker must rank the held-out rows better than chance
# by this much (AUC; an H100 read 0.643-0.686 against a ceiling of 0.705,
# PERF.md), and its device AUC / GAUC (float64 on the card) must equal
# the numpy versions (float64 on the host) within METRIC_ATOL: the same
# rank sums in another order (an H100 read <= 1.9e-15). The SparseCTR
# phases' cut depth (48 steps, the bench's 305) learns little beyond the
# popularity confound: their held-out AUC must only exceed 0.5 (an H100
# read 0.513 and 0.509; the standard error at 262,144 rows is ~0.001)
DENSE_AUC_MARGIN = 0.05
METRIC_ATOL = 1e-9
# DIN "pallas" (K2 forward, K2b backward: f32 inside, the pooled rows
# rounded once to bf16) vs DIN "xla" (torch ops rounding each bf16
# intermediate), first-epoch mean loss from the same start: an H100 read
# 1.57e-5; the control, a pool that returns zeros, 2.93e-4 (PERF.md)
DIN_IMPL_LOSS_RTOL = 1e-4
# phase 10, item2vec: the JAX package's bench corpus
# (scripts/bench_item2vec.py:44-67, its defaults: ~9.5M words, 10k vocab,
# 500 clusters, 100k docs) and run (skipgram + hs, dim 16, window 5, batch
# 65,536, min_count 1, seed 1, 3 iterations; the gate of BENCH_NOTES.md:503:
# top-5 neighbour purity >= 0.95 over 500 queries; random vectors read
# ~2·10^-3)
W2V_CORPUS = dict(n_words=9_500_000, vocab=10_000, n_clusters=500,
                  n_docs=100_000, p_in=0.85, seed=0)
W2V_BENCH_BATCH = 65_536
W2V_ITERS = 3
W2V_PROF_BLOCKS = 16
PURITY_MIN = 0.95
PURITY_CONTROL_MAX = 0.1
# item2vec card vs CPU from the same draws: the batched products sum in
# other orders and index_add_'s atomics add a hot row's terms in any
# order on the card; the trainer tolerances (TRAJ_TABLE_*), with a control
W2V_RTOL, W2V_ATOL = 1e-4, 1e-5
# Searcher's f32 similarities (TF32 off) against numpy's f64
SEARCH_ATOL = 1e-5
# phase 11, the sklearn-style MLPs: phase 9's planted 281-column rows
# (make_dense_workload), 131,072 to train and 32,768 held out; the
# classifier of the reference's main.go:42-47 ((100,), relu, adam, alpha
# 1e-5, batch "auto" = 200); the full-batch solvers 10 iterations each
MLP_ROWS, MLP_EVAL_ROWS = 131_072, 32_768
MLP_EPOCHS = 3
MLP_AUC_MIN = 0.55
MLP_FULLBATCH_ITERS = 10
# examples/futuresales.py's regressor and Neural (342 columns), 2 epochs
SALES_ROWS, SALES_EVAL_ROWS = 65_536, 16_384
SALES_EPOCHS = 2
# small MLPs card vs CPU: loss curves rtol 1e-5 (parameters: TRAJ_TABLE_*);
# lbfgs only over its first iterations: its zoom line search branches on
# f32 comparisons, and an ulp can pick another trial step later
MLP_LOSS_RTOL = 1e-5
MLP_LBFGS_TIGHT = 4


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


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
    """`timing.cuda_ms`; `torch` is taken, and unused, as this file's call
    sites and the sweep scripts pass it."""
    return timing.cuda_ms(fn, iters, warmup)


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


def pool_bounds(B, T, D):
    """(K2 bytes, K2 flop, K2b bytes, K2b flop) of the DIN pool at [B, T,
    D] bf16 with an f32 mask and att0: each input read once, each output
    written once."""
    k2b = B * T * D * 2 + 2 * B * D * 2 + B * T * 4 + T * 4
    k2f = B * T * (6 * D + 12)
    k2bb = 2 * B * T * D * 2 + 3 * B * D * 2 + B * T * 4 + 2 * T * 4
    return k2b, k2f, k2bb, B * T * (13 * D + 30)


def bound(nbytes, flops):
    """(bound ms, what bounds it) of a call that moves `nbytes` and does
    `flops` f32 operations."""
    b, f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(b, f) * 1e3, "bytes" if b >= f else "operations"


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


def device_ms(torch, fn, n_inputs, iters=24, by_kernel=None) -> float:
    """`timing.device_ms` (each kernel's mean time a launch × its launches
    a call); `torch` is taken, and unused, as in `cuda_ms`."""
    return timing.device_ms(fn, n_inputs, iters, by_kernel)


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
    rows = device_events(prof)
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
# the JAX bench's workload (goctr_tpu_torch/bench.py's copy of bench.py:44-
# 109, bit for bit), made once per argument set: the phases only read it
make_workload = functools.lru_cache(maxsize=None)(bench.make_workload)


def split_workload(n, vocab, t, u, c, seed=0, eval_rows=EVAL_ROWS):
    """bench.py's split (:163-174) of one cached draw of n + eval_rows
    rows: (train sample, held-out sample, held-out user ids, held-out
    oracle scores)."""
    return bench.split_rows(make_workload(n + eval_rows, vocab, t, u, c,
                                          seed), n)


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
    of the pooled rows), the update's ids and bf16 row gradients (the
    "xla" compaction's inputs), K9's sorted stream, and the row update's
    inputs:
    a copy of the packed table ([V, 128] rows, or grouped lines), its
    targets (slots at G = 1, lines below), the update rows K5 / K6 take
    and the new lines the split update writes with K4."""
    import copy

    from goctr_tpu_torch.ops.kernels.din_attention import din_attention_pool
    from goctr_tpu_torch.ops.kernels.row_optimizer import (
        group_size, pack_grads, pack_table, updated_lines)
    from goctr_tpu_torch.ops.losses import bce_loss
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
    rows = {"user_profile": prof, "behavior_ids": bids, "item_ids": iids,
            "ctx": ctx, "labels": y, "weights": w}
    with torch.enable_grad():
        emb = model.lookup_rows(table, rows, False, G).requires_grad_()
        beh = emb.detach()[:bs * T].view(bs, T, D)
        item = emb.detach()[bs * T:]
        mask = (bids >= 0).float()
        att0 = model.att0.detach()
        pooled = din_attention_pool(beh, item, att0, mask).requires_grad_()
        logits = model._tower(prof, pooled, item, ctx, train=True)
        dout = torch.autograd.grad(bce_loss(logits, y, w), pooled)[0]
        loss = model.batch_loss(emb, rows)
        g_emb = torch.autograd.grad(loss, emb)[0]
    ids_flat = torch.cat([bids.reshape(-1), iids])
    s_ids, g_s = sc.sort_updates(ids_flat, g_emb.float(), V)
    capr = sc.compact_slots(topt.compact_cap, s_ids.shape[0])
    tgt, rows, packed, _ = sc.update_rows(ids_flat, g_emb, topt, V)
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
            "ids_flat": ids_flat, "g_emb": g_emb,
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


def check_xla_compaction(torch, step):
    """The "xla" compaction kernel against its plain version on the first
    step's ids and bf16 row gradients: targets, overflow and the D weight
    lanes bit for bit, the packed ‖Σg‖² lane within XLA_NSQ_RTOL, the
    lanes past it 0. Control: the plain version with the hottest run's
    last row and the next run's first row swapped in the sort's order,
    which moves a row from one run to the other, must differ in some
    row. Returns (max |Δ| of the ‖Σg‖² lane relative to it, controls)."""
    from goctr_tpu_torch.ops.kernels import compact_xla as kx

    V, D, G = step["V"], step["D"], step["group"]
    ids, g, capr = step["ids_flat"], step["g_emb"], step["capr"]
    packed = G == 1
    s_ids, order = kx.sort_ids(ids, V)
    tgt, rows, over = kx.compact_xla_rows(ids, s_ids, order, g, V, capr,
                                          packed)
    w_tgt, w_rows, w_over = kx.compact_xla_rows_plain(ids, s_ids, order, g,
                                                      V, capr, packed)
    torch.cuda.synchronize()
    bits = lambda x: x.contiguous().view(torch.int32)
    require(torch.equal(tgt, w_tgt), "compact_xla: targets differ from plain")
    require(int(over) == int(w_over), "compact_xla: overflow differs")
    require(torch.equal(bits(rows[:, :D]), bits(w_rows[:, :D])),
            f"compact_xla: {int((rows[:, :D] != w_rows[:, :D]).sum())} Σg "
            "entries differ from plain")
    err = 0.0
    if packed:
        nsq, w_nsq = rows[:, D].double(), w_rows[:, D].double()
        rel = (nsq - w_nsq).abs() / w_nsq.abs().clamp_min(1e-300)
        err = float(torch.where(w_nsq == 0, (nsq != 0).double(), rel).max())
        require(err <= XLA_NSQ_RTOL, f"compact_xla: ‖Σg‖² lane off by "
                                     f"{err:.3g} of itself")
        require(torch.equal(bits(rows[:, D + 1:]), bits(w_rows[:, D + 1:])),
                "compact_xla: lanes past D not 0")
    # the control: the hottest run's last row into the next run
    real_end = torch.ones_like(s_ids, dtype=torch.bool)
    real_end[:-1] = s_ids[1:] != s_ids[:-1]
    real_end &= s_ids < V
    ends = torch.nonzero(real_end).flatten()
    lengths = torch.diff(ends, prepend=ends.new_full((1,), -1))
    lengths[ends == s_ids.numel() - 1] = 0      # a next run to move into
    e = int(ends[int(torch.argmax(lengths))])
    swapped = order.clone()
    swapped[[e, e + 1]] = order[[e + 1, e]]
    wrong = kx.compact_xla_rows_plain(ids, s_ids, swapped, g, V, capr,
                                      packed)[1]
    ctl = {"compact_xla row moved between runs": int(
        (bits(wrong[:, :D]) != bits(rows[:, :D])).any(1).sum())}
    require(ctl["compact_xla row moved between runs"] > 0,
            "compact_xla control: a row moved between runs gives the same "
            "rows")
    log(f"[train-kernels] compact_xla n={ids.numel()} D={D} "
        f"{str(g.dtype).split('.')[-1]} capr={capr} "
        f"{'packed' if packed else '[capr, D]'}: {int((w_tgt < V).sum())} "
        f"real runs (hottest {int(lengths.max())} rows), overflow "
        f"{int(over)}; targets and Σg bit-exact vs plain, ‖Σg‖² rel err "
        f"{err:.3g} (limit {XLA_NSQ_RTOL}); control: a row moved between "
        f"runs changes {ctl['compact_xla row moved between runs']} rows")
    return err, ctl


def check_train_kernels(torch, step):
    """K1, K2, K2b, the "xla" compaction, K9 and K4 against their plain
    versions on the first step's inputs, each with a control that must
    exceed its limit. Returns the max errors and the control readings."""
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
    errs["compact_xla"], c = check_xla_compaction(torch, step)
    ctl.update(c)
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


def row_sector_bytes(torch, ids, group, dim, stride) -> int:
    """Bytes of the 32-byte sectors that the distinct rows of `ids` span
    in a table of `stride` f32 lanes a line: row r is dim floats from
    float (r // group)·stride + (r % group)·(dim + 1). A grouped row of 17
    floats at D = 16 spans 2 or 3 sectors, not 64 bytes."""
    u = torch.unique(ids).long()
    start = (u // group) * stride + (u % group) * (dim + 1)
    first = start * 4 // 32
    last = ((start + dim) * 4 - 1) // 32
    return int((last - first + 1).sum()) * 32


def time_xla_compaction(torch, step):
    """Device ms of the "xla" compaction kernel and of its plain version
    (the glue it replaced) on the first step's inputs, by kernel, and its
    bound: the bytes it needs, each once (the sorted ids and the sort's
    permutation, the rows, the output rows and targets); the log line
    also gives the bound with the rows and the ids read twice, as the
    design reads them."""
    from goctr_tpu_torch.ops.kernels import compact_xla as kx
    from goctr_tpu_torch.ops.kernels.row_optimizer import LANES

    V, D, G = step["V"], step["D"], step["group"]
    ids, g, capr = step["ids_flat"], step["g_emb"], step["capr"]
    packed = G == 1
    s_ids, order = kx.sort_ids(ids, V)
    n, n0 = s_ids.numel(), ids.numel()
    parts = []
    r = dict(
        ms=device_ms(torch, lambda i: kx.compact_xla_rows(
            ids, s_ids, order, g, V, capr, packed), 1, by_kernel=parts),
        plain_ms=device_ms(torch, lambda i: kx.compact_xla_rows_plain(
            ids, s_ids, order, g, V, capr, packed), 1, iters=6),
        sort_ms=device_ms(torch, lambda i: kx.sort_ids(ids, V), 1),
        library_ms=None,
        bytes=n * 12 + n0 * D * g.element_size()
        + capr * ((LANES if packed else D) * 4 + 4) + 4,
        flops=n0 * D)
    two_reads = r["bytes"] + n * 12 + n0 * D * g.element_size()
    log(f"[train-kernels] compact_xla by kernel (D={D}), device ms per "
        f"call: " + ", ".join(f"{kernel_name(key)} {ms:.5f}"
                              for ms, key in parts)
        + f"; the id sort before it {r['sort_ms']:.5f}; bound with the rows "
        f"and ids read twice {two_reads / HBM_BYTES_PER_S * 1e3:.5f} ms "
        f"({two_reads} B)")
    return r


def time_train_kernels(torch, step):
    """Device ms of K1 (the forward gather and the split update's read),
    K2, K2b, the "xla" compaction, K9, K4 and K5 or K6 and their plain
    versions (K1's and K4's library calls; the split update beside the
    one-pass one) on the first step's inputs, with their bounds. The
    timed updates run on the step's own copy of the table."""
    from goctr_tpu_torch.ops.kernels import compact as k9
    from goctr_tpu_torch.ops.kernels import din_attention as k2
    from goctr_tpu_torch.ops.kernels import row_gather as k1
    from goctr_tpu_torch.ops.kernels import row_optimizer as k4

    V, D, G = step["V"], step["D"], step["group"]
    pool = step["pool"]
    B, T, _ = pool[1].shape
    out = {}
    # K1, the forward gather: ids and bf16 rows once each, and the 32-byte
    # sectors of each distinct row once; index_select gathers whole lines
    ids = step["gather_ids"]
    table = step["table"]
    lines = ids // G if G > 1 else ids
    out["K1"] = dict(
        ms=device_ms(torch, lambda i: k1.gather_rows(
            table, ids, group=G, dim=D, out_dtype=torch.bfloat16), 1),
        plain_ms=device_ms(torch, lambda i: k1.gather_rows_plain(
            table, ids, group=G, dim=D, out_dtype=torch.bfloat16), 1,
            iters=6),
        library_ms=device_ms(torch, lambda i: torch.index_select(
            table, 0, lines), 1),
        bytes=ids.numel() * (4 + D * 2) + row_sector_bytes(
            torch, ids, G, D, table.shape[1]),
        flops=0)
    # K1, the split update's read of all 128 f32 lanes of its targets (as
    # updated_lines reads them), the same function as index_select
    n_lines = table.shape[0]
    read_ids = step["tgt"].clamp(max=n_lines - 1)
    out["K1 read"] = dict(
        ms=device_ms(torch, lambda i: k1.gather_rows(
            table, read_ids, dim=k4.LANES), 1),
        plain_ms=device_ms(torch, lambda i: k1.gather_rows_plain(
            table, read_ids, dim=k4.LANES), 1, iters=6),
        library_ms=device_ms(torch, lambda i: torch.index_select(
            table, 0, read_ids), 1),
        bytes=read_ids.numel() * (4 + k4.LANES * 4) + row_sector_bytes(
            torch, read_ids, 1, k4.LANES, table.shape[1]),
        flops=0)
    # K2 on the pooled rows' inputs: behaviors read once, item, mask, att0
    # and the output once
    _, beh, item, att0, mask = pool
    b1, f1, b2, f2 = pool_bounds(B, T, D)
    out["K2"] = dict(
        ms=device_ms(torch, lambda i: k2.din_attention_pool(
            beh, item, att0, mask), 1),
        plain_ms=device_ms(torch, lambda i: k2.din_attention_pool_plain(
            beh, item, att0, mask), 1, iters=6),
        library_ms=None, bytes=b1, flops=f1)
    out["K2b"] = dict(
        ms=device_ms(torch, lambda i: k2.din_attention_pool_bwd(*pool), 1),
        plain_ms=device_ms(torch, lambda i: k2.din_attention_pool_bwd_plain(
            *pool), 1, iters=6),
        library_ms=None, bytes=b2, flops=f2)
    out["compact_xla"] = time_xla_compaction(torch, step)
    s_ids, g_s, capr = step["s_ids"], step["g_s"], step["capr"]
    n = s_ids.numel()
    k9_parts = []
    out["K9"] = dict(
        ms=device_ms(torch, lambda i: k9.compact_runsums_block(
            s_ids, g_s, V, capr), 1, by_kernel=k9_parts),
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
        flops=n_real * live * 8, slots=tgt.numel(), real=n_real)
    for key, r in out.items():
        r["bound_ms"] = max(r["bytes"] / HBM_BYTES_PER_S,
                            r["flops"] / F32_FLOPS_PER_S) * 1e3
        r["bound_by"] = ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                         >= r["flops"] / F32_FLOPS_PER_S else "operations")
        lib_name = {"K1": "index_select (lines)",
                    "K1 read": "index_select"}.get(key, "index_copy_")
        lib = ("" if r["library_ms"] is None else
               f", {lib_name} {r['library_ms']:.5f}")
        split_ = ("" if "split_ms" not in r else
                  f", split update (K1 read + torch + K4) "
                  f"{r['split_ms']:.5f}")
        log(f"[train-kernels] {key} device ms per call: kernel "
            f"{r['ms']:.5f}, plain {r['plain_ms']:.5f}{lib}{split_}, bound "
            f"{r['bound_ms']:.5f} ({r['bytes']} B, {r['flops']} flop, "
            f"{r['bound_by']})")
    log(f"[train-kernels] K9 by kernel (D={D}), device ms per call: "
        + ", ".join(f"{kernel_name(key)} {ms:.5f}" for ms, key in k9_parts)
        + f"; {len(k9_parts)} device operations")
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
    rows = device_events(prof)
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
    K2b, the "xla" compaction, K9, K4 and the one-pass update (K5 or K6)
    are held against their plain versions and timed, and K7 and K8 too
    when a variant trains fused2 or runfused; `small_cases` are the small
    card-vs-CPU trainers.
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
    from goctr_tpu_torch.ops.kernels.row_optimizer import LANES, group_size
    from goctr_tpu_torch.parallel.scanned import (
        TableOptConfig, TrainedScanned, table_pad_rows, train_sparse_scanned)
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
    from goctr_tpu_torch.serve.scorer import DeviceScorer

    V, T, D = model_cfg["item_vocab"], model_cfg["behavior_len"], \
        model_cfg["emb_dim"]
    G = group_size(D)
    t_phase = time.perf_counter()
    sample, ev_sample, ev_uids, ev_oracle = split_workload(
        rows, V, T, model_cfg["u_profile_dim"], model_cfg["ctx_dim"],
        seed=SEED)
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
            "scatter_rows_packed", "compact_runsums_block",
            "compact_xla_rows", rmw.__name__]
    path += [k for m, k in (("fused2", "apply_csum_updates"),
                            ("runfused", "apply_run_updates"))
             if m in sorted_modes]
    counted = counted_kernels()
    for f in counted.values():
        f.launches = 0
    by_dim = counted["gather_rows"].launches_by_dim
    by_dim.clear()
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
    # K1's two call sites: the forward gather (D lanes), the split update's
    # read (128)
    launches["gather_rows forward"] = by_dim.get(D, 0)
    launches["gather_rows read"] = by_dim.get(LANES, 0)
    path += ["gather_rows forward", "gather_rows read"]
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
    ev = eval_metrics(torch, r_main.predict(ev_sample), ev_sample.labels,
                      ev_uids, ev_oracle, dev)
    require(ev["eval_auc"] > 0.5, f"{tag}: eval AUC {ev['eval_auc']} at "
                                  f"or below chance")
    log(f"[{tag}] held-out {EVAL_ROWS} rows (bench.py:224-247): eval_auc "
        f"{ev['eval_auc']:.6f} eval_gauc {ev['eval_gauc']:.6f} "
        f"eval_auc_ceiling {ev['eval_auc_ceiling']:.6f}")
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
    test, _, _ = make_workload(MESH_PREDICT_ROWS, cfg.item_vocab,
                               cfg.behavior_len, cfg.u_profile_dim,
                               cfg.ctx_dim, seed=SEED + 5)
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
    epochs from the same start: the dense path with mean and DIN pooling,
    the sparse path in fused (split at D = 8, K5 / K6 at D = 64 / 8),
    fused2, runfused and dedup at D = 8 and D = 64. Then relu towers (the
    headline's activation) over one step (the first 1024 rows, batch 1024,
    one epoch): the dense path with DIN pooling and the sparse path in fused
    with rmw_impl="kernel", at D = 8 and D = 64, and a control (one row of
    the card's dense D = 64 table written as the next id's) that must
    exceed the table limit. Returns the control's entries outside."""
    import dataclasses

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

    def train_pair(dd, pooling, change, activation, smp, tcfg, worst):
        """(CPU result, card result) from one start, held to the limits."""
        mc = dict(item_vocab=vocab, emb_dim=dd, u_profile_dim=4, ctx_dim=2,
                  behavior_len=5, hidden=(16,), pooling=pooling,
                  activation=activation)
        m0 = SparseCTR(**mc, device="cpu")
        start = TrainedSparseRanker(
            model=m0, table=m0.init_params(torch.Generator().manual_seed(
                SEED)), mesh=cpu, loss_curve=[])
        topt = (None if change is None
                else TableOptConfig(kind="adagrad", lr=0.05, **change))
        c, g = (train_sparse(SparseCTR(**mc, device=m.device), smp, m,
                             tcfg, table_opt=topt, resume_from=start)
                for m in (cpu, mesh))
        what = (f"small mesh trainer D={dd} {pooling} {activation} "
                f"{change or 'dense'}")
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
        return c, g

    worst = [0.0, 0.0]
    for dd, pooling, change in cases:
        train_pair(dd, pooling, change, "tanh", sample, cfg, worst)
    log(f"[mesh] small f32 mesh trainers, card (kernels) vs CPU (plain), "
        f"{len(cases)} configurations (dense mean and DIN; fused, fused2, "
        f"runfused, dedup at D = 8 and 64), 3 epochs: max loss rel diff "
        f"{worst[0]:.3g} (rtol {TRAJ_LOSS_RTOL}), max table/acc err "
        f"{worst[1]:.3g} (rtol {TRAJ_TABLE_RTOL}, atol {TRAJ_TABLE_ATOL})")
    # relu towers over one step: adam's and adagrad's first steps scale
    # each entry by its own gradient's size, so a relu pre-activation
    # within rounding of 0 for one row moves a weight's gradient by that
    # row's share without changing its step, and nothing compounds
    one = SparseSample(**{f.name: getattr(sample, f.name)[:1024]
                          for f in dataclasses.fields(sample)})
    cfg1 = dataclasses.replace(cfg, epochs=1)
    relu = [0.0, 0.0]
    for dd in (8, 64):
        train_pair(dd, "din_attention", dict(update_mode="fused",
                                             rmw_impl="kernel"),
                   "relu", one, cfg1, relu)
        c, g = train_pair(dd, "din_attention", None, "relu", one, cfg1, relu)
    # control: the card's D = 64 dense table with one trained row written
    # as the next id's
    row = int(one.item_ids[0])              # trained in this step
    wrong = g.table.cpu().clone()
    wrong[row] = wrong[(row + 1) % vocab]
    ctl, _ = within(torch, wrong, c.table, TRAJ_TABLE_RTOL, TRAJ_TABLE_ATOL)
    log(f"[mesh] relu towers, one step, card vs CPU: dense DIN and sparse "
        f"fused K5/K6 at D = 8 and 64: max loss rel diff {relu[0]:.3g} "
        f"(rtol {TRAJ_LOSS_RTOL}), max table/acc err {relu[1]:.3g} (rtol "
        f"{TRAJ_TABLE_RTOL}, atol {TRAJ_TABLE_ATOL}); control, row {row} "
        f"written as the next id's: {ctl} entries outside")
    require(ctl > 0, "relu control: a wrong table row passes the limit")
    return ctl


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
    g_sample = split_workload(GROUPED_TRAIN_ROWS, GROUPED["item_vocab"],
                              GROUPED["behavior_len"],
                              GROUPED["u_profile_dim"], GROUPED["ctx_dim"],
                              seed=SEED)[0]
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
    sample = split_workload(TRAIN_ROWS, V, T, HEADLINE["u_profile_dim"],
                            HEADLINE["ctx_dim"], seed=SEED)[0]
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
    ctl["relu small mesh row shifted"] = small_mesh_check(torch, dev, mesh)
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


# ------------------------------------------------------------- phase 9 --
def ml20m_info():
    """The ML-20M protocol's SampleInfo: profile, behaviors, item, ctx."""
    from goctr_tpu_torch.models.base import SampleInfo

    u, t, d = ML20M["u_profile_dim"], ML20M["behavior_len"], \
        ML20M["behavior_dim"]
    it, cx = ML20M["i_feature_dim"], ML20M["c_feature_dim"]
    ub = u + t * d
    return SampleInfo((0, u), (u, ub), (ub, ub + it),
                      (ub + it, ub + it + cx))


@functools.lru_cache(maxsize=None)
def make_dense_workload(n, n_eval, seed=0):
    """Rows of the ML-20M protocol's layout drawn as tests/test_models.py
    draws its planted rows, at these widths: profile, behavior 1 (the
    second), item and ctx uniform [0, 1), the other behaviors 0; its rule:
    d1 = mean |profile − the first 52 ctx columns|, d2 = mean |behavior 1
    − item|;
    the clean label is 1 for the DENSE_POS_RATE share of rows with the
    largest d1 + d2 (the test rule's rate), and LABEL_FLIP of the labels
    flip, as in bench.py's noisy workload. Users are zipf (s = 1.05) over
    (n + n_eval) // 2048 ids, for GAUC. Returns (train TrainSample, eval
    x, eval labels, eval user ids, eval oracle scores): the oracle is the
    clean label, the Bayes-optimal score under the flips."""
    from goctr_tpu_torch.models.base import TrainSample

    info = ml20m_info()
    rng = np.random.default_rng(seed)
    total = n + n_eval
    x = rng.random((total, info.width), dtype=np.float32)
    u0, u1 = info.user_profile_range
    c0 = info.ctx_feature_range[0]
    b0 = info.user_behavior_range[0]
    b1 = b0 + ML20M["behavior_dim"]
    i0, i1 = info.item_feature_range
    x[:, b0:b1] = 0.0
    x[:, b1 + ML20M["behavior_dim"]:i0] = 0.0
    d1 = x[:, u0:u1].mean(1) * x[:, c0:c0 + u1 - u0].mean(1)
    d2 = x[:, b1:b1 + i1 - i0].mean(1) * x[:, i0:i1].mean(1)
    s = d1 + d2
    clean = (s > np.quantile(s, 1.0 - DENSE_POS_RATE)).astype(np.float32)
    y = np.where(rng.random(total) < LABEL_FLIP, 1.0 - clean,
                 clean).astype(np.float32)
    uids = _zipf_ranks(rng, total, max(total // 2048, 1)).astype(np.int32)
    return (TrainSample(x=x[:n], y=y[:n], info=info), x[n:], y[n:],
            uids[n:], clean[n:])


def dense_models(torch, **kw):
    """(name, model, l2) of the ML-20M protocol's three rankers at its
    widths, bf16 compute (use_bf16=True), DIN in both attention_impls;
    `kw` overrides the model fields."""
    from goctr_tpu_torch.models import DIN, MLPTower, YoutubeDNN

    widths = tuple(ML20M.values())
    w = ml20m_info().width
    kw = dict(dict(compute_dtype=torch.bfloat16), **kw)
    mlp_kw = {k: v for k, v in kw.items() if k != "dropout_rates"}
    return [("mlp", MLPTower(in_dim=w, **mlp_kw), 1e-5),
            ("youtube", YoutubeDNN(*widths, **kw), 1e-4),
            ("din xla", DIN(*widths, **kw), 1e-4),
            ("din pallas", DIN(*widths, **kw, attention_impl="pallas"),
             1e-4)]


def dense_cfg(l2):
    """The ML-20M protocol's trainer settings (scripts/parity_ml20m.py
    :232-243) with the phase's epochs and early stopping off."""
    from goctr_tpu_torch.models.trainer import TrainerConfig

    return TrainerConfig(batch_size=DENSE_BATCH, epochs=DENSE_EPOCHS,
                         early_stop=0, lr=1e-3, l2=l2,
                         store_dtype="float16", seed=SEED)


def dense_first_step(torch, model, sample, cfg, dev):
    """The DIN "pallas" run's first step rebuilt with the trainer's own
    functions: the first epoch's first batch (cfg.store_dtype upcast), the
    fresh parameters, K2's inputs (behaviors and item contiguous in bf16,
    att0 rounded to bf16, mask all ones) and K2b's: the tower's gradient
    of the pooled rows under the first step's dropout masks."""
    from goctr_tpu_torch.models.base import split_blocks
    from goctr_tpu_torch.models.mlp_tower import tower
    from goctr_tpu_torch.models.trainer import (
        run_generators, torch_store_dtype, upload_rows)
    from goctr_tpu_torch.ops.kernels import din_attention as k2
    from goctr_tpu_torch.ops.losses import bce_loss

    n, bs = sample.rows, cfg.batch_size
    n_pad = -(-n // bs) * bs
    shuffle_gen, drop_gen = run_generators(cfg, 0, dev)
    idx = torch.randperm(n_pad, generator=shuffle_gen, device=dev)[:bs]
    idx_h = idx.cpu().numpy()
    real = idx_h < n
    xh = np.zeros((bs, sample.x.shape[1]), np.float32)
    xh[real] = sample.x[idx_h[real]]
    xb = upload_rows(xh, bs, torch_store_dtype(cfg.store_dtype),
                     dev).float()
    yh = np.zeros(bs, np.float32)
    yh[real] = sample.y[idx_h[real]]
    y = torch.from_numpy(yh).to(dev)
    w = torch.from_numpy(real.astype(np.float32)).to(dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(
        cfg.seed))
    cd = model.compute_dtype
    prof, beh, item, ctx = split_blocks(xb, sample.info, model.behavior_len)
    beh = beh.to(cd).contiguous()
    item = item.to(cd).contiguous()
    att0 = params["att0"].to(cd).float()
    mask = torch.ones(beh.shape[:2], device=dev)
    with torch.enable_grad():
        pooled = k2.din_attention_pool(beh, item, att0,
                                       mask).requires_grad_()
        h = torch.cat([prof.to(cd), pooled, item, ctx.to(cd)], dim=1)
        logits = tower(params, h, cd, model.activation, model.dropout_rates,
                       True, drop_gen)
        dout = torch.autograd.grad(bce_loss(logits, y, w), pooled)[0]
    return {"pool": (dout.contiguous(), beh, item, att0, mask),
            "pooled": pooled.detach(), "params": params, "xb": xb,
            "y": y, "w": w}


def check_dense_kernels(torch, step, tag="dense-kernels"):
    """K2 and K2b against their plain versions on the dense DIN's first
    step, with the phase-6 limits and controls that must exceed them: a
    zeroed pool (K2) and d_att0 shifted by one position (K2b). Returns
    (max errors, control readings)."""
    from goctr_tpu_torch.ops.kernels import din_attention as k2

    dout, beh, item, att0, mask = step["pool"]
    errs, ctl = {}, {}
    want = k2.din_attention_pool_plain(beh, item, att0, mask)
    torch.cuda.synchronize()
    errs["K2"] = max_err(torch, step["pooled"], want, "bfloat16",
                         "K2 dense DIN forward")
    atol, rtol = TOL["bfloat16"]
    ctl["K2 pool zeroed"], _ = within(torch, torch.zeros_like(want), want,
                                      rtol, atol)
    require(ctl["K2 pool zeroed"] > 0,
            "dense K2 control: a zeroed pool passes the limit")
    got = k2.din_attention_pool_bwd(*step["pool"])
    want = k2.din_attention_pool_bwd_plain(*step["pool"])
    torch.cuda.synchronize()
    for name, g, w_ in (("d_behaviors", got[0], want[0]),
                        ("d_item", got[1], want[1])):
        g_atol = GRAD_ATOL_REL * float(w_.float().abs().max())
        bad, err = within(torch, g, w_, GRAD_RTOL_BF16, g_atol)
        require(bad == 0, f"dense K2b {name}: {bad} entries outside rtol "
                          f"2^-7 + atol {g_atol:.3g} (max err {err:.3g})")
        errs[f"K2b {name}"] = err
    a_atol = ATT0_ATOL_REL * float(want[2].abs().max())
    bad, errs["K2b d_att0"] = within(torch, got[2], want[2], ATT0_RTOL,
                                     a_atol)
    require(bad == 0, f"dense K2b d_att0: {bad} entries outside rtol "
                      f"{ATT0_RTOL} + {ATT0_ATOL_REL}·max")
    ctl["K2b d_att0 shifted"], _ = within(
        torch, torch.roll(got[2], 1), want[2], ATT0_RTOL, a_atol)
    require(ctl["K2b d_att0 shifted"] > 0,
            "dense K2b control: d_att0 shifted by one passes the limit")
    log(f"[{tag}] K2 B,T,D={tuple(beh.shape)} bf16, no mask, vs "
        f"plain: max err {errs['K2']:.3g} (tol atol={atol} rtol={rtol}); "
        f"K2b max err d_behaviors {errs['K2b d_behaviors']:.3g}, d_item "
        f"{errs['K2b d_item']:.3g}, d_att0 {errs['K2b d_att0']:.3g} "
        f"(limits rtol 2^-7 + {GRAD_ATOL_REL}·max; d_att0 rtol {ATT0_RTOL}"
        f" + {ATT0_ATOL_REL}·max); d_att0 {got[2].tolist()}; controls: a "
        f"zeroed pool leaves {ctl['K2 pool zeroed']} entries outside, "
        f"d_att0 shifted by one {ctl['K2b d_att0 shifted']}")
    return errs, ctl


def time_dense_kernels(torch, step, tag="dense-kernels"):
    """Device ms of K2 and K2b and their plain versions on the first
    step's inputs, with their bounds."""
    from goctr_tpu_torch.ops.kernels import din_attention as k2

    pool = step["pool"]
    B, T, D = pool[1].shape
    k2_bytes, k2_flops, k2b_bytes, k2b_flops = pool_bounds(B, T, D)
    out = {}
    for key, fn, plain, nb, nf in (
            ("K2", lambda i: k2.din_attention_pool(*pool[1:]),
             lambda i: k2.din_attention_pool_plain(*pool[1:]),
             k2_bytes, k2_flops),
            ("K2b", lambda i: k2.din_attention_pool_bwd(*pool),
             lambda i: k2.din_attention_pool_bwd_plain(*pool),
             k2b_bytes, k2b_flops)):
        r = dict(ms=device_ms(torch, fn, 1),
                 plain_ms=device_ms(torch, plain, 1, iters=6),
                 library_ms=None)
        r["bound_ms"], r["bound_by"] = bound(nb, nf)
        out[key] = r
        log(f"[{tag}] {key} B,T,D=({B}, {T}, {D}) bf16 device ms "
            f"per call: kernel {r['ms']:.5f}, plain {r['plain_ms']:.5f}, "
            f"bound {r['bound_ms']:.5f} ({nb} B, {nf} flop, "
            f"{r['bound_by']})")
    return out


def long_sequence_pool(torch, dev):
    """The DIN pool at B = 1,024, T = 512, D = 64 bf16 (the JAX model's
    own comparison shape, models/din.py:43-47), through K2 and through
    the "xla" torch ops, device ms per call; the two must agree to bf16
    precision."""
    from goctr_tpu_torch.models import DIN
    from goctr_tpu_torch.ops.kernels import din_attention as k2

    B, T, D = 1024, 512, 64
    rng = np.random.default_rng(SEED + 9)
    beh = torch.from_numpy(rng.standard_normal((B, T, D), np.float32)).to(
        dev, torch.bfloat16)
    item = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(
        dev, torch.bfloat16)
    att0 = torch.from_numpy(rng.uniform(0.5, 1.5, T).astype(np.float32)).to(
        dev)
    mask = torch.ones(B, T, device=dev)
    xla = DIN(4, T, D, D, 2, compute_dtype=torch.bfloat16)
    got = k2.din_attention_pool(beh, item, att0, mask)
    want = xla.pool(att0, beh, item)
    bad, err = within(torch, got, want, 2 * GRAD_RTOL_BF16, 1e-3)
    require(bad == 0, f"long-sequence pool: K2 vs xla {bad} entries "
                      f"outside (max err {err:.3g})")
    k2_ms = device_ms(torch, lambda i: k2.din_attention_pool(
        beh, item, att0, mask), 1)
    xla_ms = device_ms(torch, lambda i: xla.pool(att0, beh, item), 1)
    nb, nf, _, _ = pool_bounds(B, T, D)
    b_ms, by = bound(nb, nf)
    log(f"[dense] long-sequence DIN pool B,T,D=({B}, {T}, {D}) bf16, "
        f"device ms per call: K2 (attention_impl=\"pallas\") {k2_ms:.5f}, "
        f"torch ops (\"xla\") {xla_ms:.5f}, bound {b_ms:.5f} ({by}); K2 vs "
        f"xla max diff {err:.3g}")
    return {"k2_ms": k2_ms, "xla_ms": xla_ms, "bound_ms": b_ms}


def small_dense_check(torch, dev):
    """Small f32 dense rankers at the test widths (U = 5, T = 3, D = 7,
    item 7, ctx 5; D = 7 takes K2's generic path) trained 2 epochs on
    the card and on the CPU from the same start, shuffle off and dropout
    0 (the generators of two devices differ), for each model and both DIN
    impls: loss curves within TRAJ_LOSS_RTOL, parameters within
    TRAJ_TABLE_RTOL / TRAJ_TABLE_ATOL."""
    from goctr_tpu_torch.models import (
        DIN, MLPTower, SampleInfo, TrainSample, YoutubeDNN, train_ranker)
    from goctr_tpu_torch.models.base import param_leaves
    from goctr_tpu_torch.models.trainer import TrainedRanker, TrainerConfig

    U, T, D, IT, C = 5, 3, 7, 7, 5
    W = U + T * D + IT + C
    info = SampleInfo((0, U), (U, U + T * D), (U + T * D, U + T * D + IT),
                      (U + T * D + IT, W))
    rng = np.random.default_rng(SEED + 10)
    x = rng.random((1000, W), dtype=np.float32)
    y = (rng.random(1000) < 0.3).astype(np.float32)
    sample = TrainSample(x=x, y=y, info=info)
    cfg = TrainerConfig(batch_size=200, epochs=2, early_stop=0, lr=3e-3,
                        shuffle=False)
    models = [MLPTower(in_dim=W, hidden=(16,)),
              YoutubeDNN(U, T, D, IT, C, hidden=(16, 8),
                         dropout_rates=(0.0, 0.0)),
              DIN(U, T, D, IT, C, hidden=(16, 8), dropout_rates=(0.0, 0.0)),
              DIN(U, T, D, IT, C, hidden=(16, 8), dropout_rates=(0.0, 0.0),
                  attention_impl="pallas")]
    worst = [0.0, 0.0]
    for m in models:
        p0 = m.init_params(torch.Generator().manual_seed(SEED))
        out = {}
        for d in ("cpu", dev):
            start = TrainedRanker(model=m, params=p0, info=info,
                                  behavior_len=m.behavior_len,
                                  loss_curve=[])
            out[str(d)] = train_ranker(m, sample, cfg, resume_from=start,
                                       device=d)
        c, g = out["cpu"], out[str(dev)]
        what = f"small dense {type(m).__name__} " + getattr(
            m, "attention_impl", "")
        lc = np.abs(np.array(g.loss_curve) - c.loss_curve) / np.abs(
            c.loss_curve)
        worst[0] = max(worst[0], float(lc.max()))
        require(lc.max() <= TRAJ_LOSS_RTOL,
                f"{what}: loss curves differ by {lc.max():.3g}")
        for a, b in zip(param_leaves(g.params), param_leaves(c.params)):
            bad, err = within(torch, a.cpu(), b, TRAJ_TABLE_RTOL,
                              TRAJ_TABLE_ATOL)
            worst[1] = max(worst[1], err)
            require(bad == 0, f"{what}: {bad} parameters outside (max err "
                              f"{err:.3g})")
    log(f"[dense] small f32 rankers (U,T,D=5,3,7), card vs CPU, 2 epochs, "
        f"MLP, YouTube-DNN, DIN xla and pallas: max loss rel diff "
        f"{worst[0]:.3g} (rtol {TRAJ_LOSS_RTOL}), max parameter err "
        f"{worst[1]:.3g} (rtol {TRAJ_TABLE_RTOL}, atol {TRAJ_TABLE_ATOL})")


def eval_metrics(torch, scores, y, uids, oracle, dev, check_numpy=False):
    """Held-out AUC, GAUC and the oracle's AUC (the ceiling) by the
    device metrics; with check_numpy also held to the numpy versions
    within METRIC_ATOL. Returns the readings."""
    from goctr_tpu_torch.core import metrics as mt

    s_d = torch.from_numpy(np.asarray(scores, np.float32)).to(dev)
    y_d = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
    u_d = torch.from_numpy(np.asarray(uids)).to(dev)
    auc_d = mt.roc_auc_device(s_d, y_d)
    gauc_d = mt.gauc_device(s_d, y_d, u_d)
    ceil_d = mt.roc_auc_device(torch.from_numpy(
        np.asarray(oracle, np.float32)).to(dev), y_d)
    out = {"eval_auc": float(auc_d), "eval_gauc": float(gauc_d),
           "eval_auc_ceiling": float(ceil_d)}
    require(all(np.isfinite(v) for v in out.values()),
            f"eval metrics not finite: {out}")
    if check_numpy:
        auc_np = mt.roc_auc_score(y, scores)
        gauc_np = mt.gauc_np(y, scores, uids)
        out["metric_err"] = max(abs(out["eval_auc"] - auc_np),
                                abs(out["eval_gauc"] - gauc_np))
        require(out["metric_err"] <= METRIC_ATOL,
                f"device metrics vs numpy: AUC {out['eval_auc']} vs "
                f"{auc_np}, GAUC {out['eval_gauc']} vs {gauc_np}")
    return out


def din_zero_pool(model):
    """A DIN whose pool returns zeros, as a K2 that writes nothing would:
    the control of the impl comparison."""
    import dataclasses

    class ZeroPool(type(model)):
        def pool(self, att0, behaviors, item):
            return super().pool(att0, behaviors, item) * 0.0

    return ZeroPool(**{f.name: getattr(model, f.name)
                       for f in dataclasses.fields(model)})


def profile_dense_steps(torch, r, sample, cfg, dev, steps=3):
    """profile_steps over training steps of a trained dense ranker (a
    copy of its parameters and solver state), batches from the start of
    the f16 rows."""
    from goctr_tpu_torch.models.base import param_leaves
    from goctr_tpu_torch.models.trainer import (
        _params_on, make_trainer_solver, train_step, upload_rows)

    bs = cfg.batch_size
    params = _params_on(r.params, dev)
    for p in param_leaves(params):
        p.requires_grad_(True)
    state = [x.clone() for x in r.opt_state]
    solver = make_trainer_solver(cfg)
    xd = upload_rows(sample.x[:4 * bs], 4 * bs, torch.float16, dev)
    yd = torch.from_numpy(sample.y[:4 * bs]).to(dev)
    w = torch.ones(bs, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def step(i):
        nonlocal state
        sl = slice((i % 4) * bs, (i % 4 + 1) * bs)
        _, state = train_step(r.model, params, solver, state,
                              xd[sl].float(), yd[sl], w, sample.info, gen)

    return profile_steps(torch, step, "dense-profile", steps)


def dense_phase(torch, dev):
    """Phase 9: the dense rankers (MLPTower, YoutubeDNN, DIN in both
    attention_impls) trained by train_ranker at the ML-20M protocol's
    widths (W = 281, batch 16,384, adam 1e-3, f16 storage, bf16 compute)
    on DENSE_ROWS rows for DENSE_EPOCHS epochs from seed SEED, scored on
    EVAL_ROWS held-out rows with predict_all, AUC and GAUC on the device
    held to numpy. K2 and K2b checked and timed on the DIN "pallas" run's
    first step; the long-sequence pool through K2 and the "xla" ops;
    small f32 rankers card vs CPU. Returns the kernels-line entries of
    K2 and K2b at the dense shape."""
    import dataclasses

    from goctr_tpu_torch.models import train_ranker

    t_phase = time.perf_counter()
    sample, x_ev, y_ev, u_ev, oracle = make_dense_workload(
        DENSE_ROWS, EVAL_ROWS, seed=SEED)
    steps = -(-DENSE_ROWS // DENSE_BATCH)
    log(f"[dense] workload {DENSE_ROWS} + {EVAL_ROWS} held-out rows × "
        f"{sample.x.shape[1]} columns ({steps} steps of {DENSE_BATCH}), "
        f"positive rate {sample.y.mean():.4f}, {len(np.unique(u_ev))} "
        f"held-out users, in {time.perf_counter() - t_phase:.1f} s")
    models = dense_models(torch)
    pallas = models[3]
    step = dense_first_step(torch, pallas[1], sample, dense_cfg(pallas[2]),
                            dev)
    errs, ctl = check_dense_kernels(torch, step)
    times = time_dense_kernels(torch, step)
    del step
    long_seq = long_sequence_pool(torch, dev)
    small_dense_check(torch, dev)
    torch.cuda.empty_cache()

    # the main path: counts reset just before, read just after
    counted = counted_kernels()
    for f in counted.values():
        f.launches = 0
    results, readings = {}, {}
    for name, model, l2 in models:
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 1e9     # earlier phases'
        r = train_ranker(model, sample, dense_cfg(l2), device=dev)
        scores = r.predict_all(x_ev)
        peak = torch.cuda.max_memory_allocated() / 1e9 - held
        lc = r.loss_curve
        require(all(np.isfinite(lc)) and lc[-1] < lc[0],
                f"dense {name}: the loss does not fall {lc}")
        m = eval_metrics(torch, scores, y_ev, u_ev, oracle, dev,
                         check_numpy=True)
        require(m["eval_auc"] > 0.5 + DENSE_AUC_MARGIN,
                f"dense {name}: eval AUC {m['eval_auc']} within "
                f"{DENSE_AUC_MARGIN} of chance")
        rate = DENSE_ROWS * (DENSE_EPOCHS - 1) / sum(r.epoch_times[1:])
        step_ms = sum(r.epoch_times[1:]) / (steps * (DENSE_EPOCHS - 1)) * 1e3
        results[name] = r
        readings[name] = dict(m, rate=rate, step_ms=step_ms, peak=peak)
        log(f"[dense] {name}: loss curve {lc}, epoch s {r.epoch_times}; "
            f"steady-state {rate:.1f} ex/s, step {step_ms:.3f} ms; peak "
            f"device memory {peak:.2f} GB above the {held:.2f} GB earlier "
            f"phases hold; eval_auc {m['eval_auc']:.6f} "
            f"eval_gauc {m['eval_gauc']:.6f} (ceiling "
            f"{m['eval_auc_ceiling']:.6f}; device vs numpy max diff "
            f"{m['metric_err']:.3g}, limit {METRIC_ATOL})")
    launches = {k: f.launches for k, f in counted.items()}
    require(launches["din_attention_pool"] > 0
            and launches["din_attention_pool_bwd"] > 0,
            f"dense: a kernel of the path was never launched {launches}")
    per_epoch = launches["din_attention_pool_bwd"] // DENSE_EPOCHS
    l_x, l_p = (results[k].loss_curve[0] for k in ("din xla", "din pallas"))
    rel = abs(l_p - l_x) / abs(l_x)
    require(rel <= DIN_IMPL_LOSS_RTOL,
            f"dense DIN pallas vs xla first-epoch loss {l_p} vs {l_x} (rel "
            f"{rel:.3g} > {DIN_IMPL_LOSS_RTOL})")
    r_ctl = train_ranker(din_zero_pool(pallas[1]), sample,
                         dataclasses.replace(dense_cfg(pallas[2]), epochs=1),
                         device=dev)
    ctl["DIN pool zeroed"] = abs(r_ctl.loss_curve[0] - l_x) / abs(l_x)
    require(ctl["DIN pool zeroed"] > DIN_IMPL_LOSS_RTOL,
            f"dense control: DIN with its pool zeroed reads "
            f"{ctl['DIN pool zeroed']:.3g}, inside {DIN_IMPL_LOSS_RTOL}")
    prof = profile_dense_steps(torch, results["din pallas"], sample,
                               dense_cfg(pallas[2]), dev)
    del results, r_ctl
    torch.cuda.empty_cache()
    log(f"[dense] done in {time.perf_counter() - t_phase:.1f} s: DIN "
        f"pallas vs xla first-epoch loss rel diff {rel:.3g} (limit "
        f"{DIN_IMPL_LOSS_RTOL}); launches {launches} (K2b {per_epoch} an "
        f"epoch); profiled DIN pallas step device busy "
        f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f}; "
        f"long-sequence pool K2 {long_seq['k2_ms']:.5f} ms vs xla "
        f"{long_seq['xla_ms']:.5f}; controls {ctl}; readings {readings}")
    entries = []
    for key, name, src, replaces, count in (
            ("K2", "din_attention (dense DIN)", "din_attention.cu",
             "goctr_tpu/ops/pallas/din_attention.py:97",
             "din_attention_pool"),
            ("K2b", "din_attention_bwd (dense DIN)", "din_attention_bwd.cu",
             "goctr_tpu/parallel/sparse_ctr.py:128",
             "din_attention_pool_bwd")):
        r = times[key]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"goctr_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[count],
            "max_abs_err": max(v for k, v in errs.items()
                               if k.split()[0] == key),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    return entries, readings


# ------------------------------------------------------------ phase 10 --
class IterLog:
    """Collects Word2Vec's per-iteration records (verbose=True logs each
    iteration's examples and seconds after its one sync)."""

    def __init__(self):
        import logging

        self.rows = []
        handler = logging.Handler()
        handler.emit = lambda r: self.rows.append(r.args[:3]) \
            if r.msg.startswith("iter") else None
        self.logger = logging.getLogger("goctr_tpu_torch.embedding.word2vec")
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(handler)
        self.handler = handler

    def close(self):
        self.logger.removeHandler(self.handler)


def w2v_with_draws(torch, dev, source_dev):
    """A Word2Vec subclass on `dev` whose draws come from a generator on
    `source_dev` (seed·1000 + iteration) and are moved to `dev`: the card
    and the CPU then train on the same draws."""
    from goctr_tpu_torch.embedding.word2vec import EpochDraws, Word2Vec

    class SameDraws(Word2Vec):
        def _draws(self, gen, it, chunk, n):
            g = torch.Generator(device=source_dev).manual_seed(
                self.opts.seed * 1000 + it)
            d = Word2Vec._draws(self, g, it, chunk, n)
            neg = d.negatives
            return EpochDraws(d.uniform.to(dev), d.radius.to(dev),
                              None if neg is None else
                              (lambda b: neg(b).to(dev)))
    return SameDraws


def check_w2v_card_vs_cpu(torch, dev):
    """All four combinations on a small corpus (~20k words, vocab 200),
    the card and the CPU fed the same draws: tables within W2V_ATOL /
    W2V_RTOL; control: the card's w_in with one row written as the next
    id's."""
    raw, _ = bench_item2vec.make_cluster_corpus(20_000, 200, 10, 400,
                                                seed=SEED + 3)
    docs = [[str(w) for w in d] for d in raw]
    worst, ctl = 0.0, []
    for model in ("skipgram", "cbow"):
        for opt in ("hs", "ns"):
            kw = dict(dim=16, window=5, iters=2, min_count=1,
                      batch_size=2048, seed=SEED + 4, model=model,
                      optimizer=opt)
            out = {str(d): w2v_with_draws(torch, d, "cpu")(
                **kw, device=d).train(docs) for d in ("cpu", dev)}
            c, g = out["cpu"], out[str(dev)]
            for name in ("w_in", "w_out"):
                bad, err = within(torch, torch.from_numpy(getattr(g, name)),
                                  torch.from_numpy(getattr(c, name)),
                                  W2V_RTOL, W2V_ATOL)
                worst = max(worst, err)
                require(bad == 0, f"item2vec {model}/{opt} card vs CPU: "
                                  f"{bad} {name} entries outside (max err "
                                  f"{err:.3g})")
            require(g.words_trained == c.words_trained,
                    f"item2vec {model}/{opt}: pairs {g.words_trained} vs "
                    f"{c.words_trained}")
            wrong = g.w_in.copy()
            wrong[0] = wrong[1]
            bad, err = within(torch, torch.from_numpy(wrong),
                              torch.from_numpy(c.w_in), W2V_RTOL, W2V_ATOL)
            ctl.append(err)
            require(bad > 0, f"item2vec control {model}/{opt} reads {err}")
    log(f"[item2vec] card vs CPU, same draws, 4 combinations × 2 "
        f"iterations on {sum(map(len, docs))} words: max table err "
        f"{worst:.3g} (atol {W2V_ATOL}, rtol {W2V_RTOL}); controls (a row "
        f"written as the next id's) read {min(ctl):.3g} and more")
    return worst


def check_searcher(torch, dev, emb):
    """Searcher on the card: top-10 of 1,000 queries against numpy's
    float64 similarities: each returned similarity within SEARCH_ATOL of
    numpy's for that word, and the k-th within SEARCH_ATOL of numpy's
    k-th best."""
    from goctr_tpu_torch.embedding.search import Searcher

    words, mat = emb.as_arrays()
    s = Searcher(emb, device=dev)
    q = mat[:1000]
    t0 = time.perf_counter()
    res = s.search_vec(q, 10)
    ms = (time.perf_counter() - t0) * 1e3
    vn = mat / np.maximum(np.linalg.norm(mat, axis=1, keepdims=True), 1e-12)
    qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    sims = qn.astype(np.float64) @ vn.T.astype(np.float64)
    best = -np.sort(-sims, axis=1)[:, :10]
    index = {w: i for i, w in enumerate(words)}
    err = 0.0
    for r, row in enumerate(res):
        got = np.array([sims[r, index[w]] for w, _ in row])
        err = max(err, np.abs(got - [v for _, v in row]).max(),
                  (best[r] - got).max())
    require(err <= SEARCH_ATOL, f"Searcher top-10 vs numpy: {err:.3g}")
    neighbours = s.search(words[0], 5)
    require(len(neighbours) == 5 and words[0] not in
            [w for w, _ in neighbours], f"Searcher.search: {neighbours}")
    log(f"[item2vec] Searcher on the card: 1,000 queries × {len(words)} "
        f"words top-10 in {ms:.1f} ms, max err vs numpy {err:.3g} (limit "
        f"{SEARCH_ATOL})")


def item2vec_phase(torch, dev):
    """Phase 10: item2vec at the JAX bench's size (run A), the pipeline's
    train_embedding call (run B), a profiled slice of blocks, the
    neighbour-purity gate with a control, card vs CPU, Searcher and the
    text round trip. Returns the readings."""
    import io

    from goctr_tpu_torch.embedding import store

    t_phase = time.perf_counter()
    raw, cluster_of = bench_item2vec.make_cluster_corpus(**W2V_CORPUS)
    docs = [[str(w) for w in d] for d in raw]
    n_words = sum(map(len, docs))
    t_corpus = time.perf_counter() - t_phase
    kw = dict(bench_item2vec.options(W2V_BENCH_BATCH), verbose=True)
    iters = IterLog()
    try:
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 1e9
        w2v, wall_a = bench_item2vec.timed_train(docs, W2V_ITERS, dev, **kw)
        peak = torch.cuda.max_memory_allocated() / 1e9 - held
        run_a, iters.rows = iters.rows, []
        t0 = time.perf_counter()
        emb_b = store.train_embedding(docs, window=5, dim=16, iters=1,
                                      verbose=True, device=dev)
        wall_b = time.perf_counter() - t0
        run_b = iters.rows
    finally:
        iters.close()
    steady = run_a[1:]
    secs = sum(r[2] for r in steady)
    rate_a = n_words * len(steady) / secs
    pairs_a = sum(r[1] for r in steady) / secs
    rate_b = n_words / run_b[0][2]
    ids = bench_item2vec.item_ids(w2v)
    purity = bench_item2vec.neighbor_purity(w2v.vectors(), ids, cluster_of)
    control = bench_item2vec.neighbor_purity(
        np.random.default_rng(SEED).normal(size=w2v.vectors().shape), ids,
        cluster_of)
    require(purity >= PURITY_MIN, f"item2vec purity {purity} < {PURITY_MIN}")
    require(control <= PURITY_CONTROL_MAX,
            f"item2vec purity control (random vectors) reads {control}")
    bp_a, bp_b = w2v._block_positions(), 8192 // 10      # 2·window = 10
    log(f"[item2vec] corpus {n_words} words, {len(docs)} docs, vocab "
        f"{len(w2v.dictionary)} (drawn in {t_corpus:.1f} s). Run A "
        f"(skipgram + hs, dim 16, window 5, batch {W2V_BENCH_BATCH}: bp "
        f"{bp_a}, ~{-(-n_words // bp_a)} blocks; {W2V_ITERS} iterations): "
        f"iteration s {[round(r[2], 4) for r in run_a]}, pairs "
        f"{[r[1] for r in run_a]}; over iterations 2-{W2V_ITERS} "
        f"{rate_a:.1f} words/s, {pairs_a:.1f} pair-updates/s; the call "
        f"{wall_a:.1f} s; peak device memory {peak:.3f} GB above the "
        f"{held:.2f} GB earlier phases hold; top-5 neighbour purity "
        f"{purity:.4f} (gate {PURITY_MIN}; random vectors {control:.4f}). "
        f"Run B (train_embedding: batch 8192, bp {bp_b}, min_count 5, one "
        f"iteration): {run_b[0][2]:.4f} s, {rate_b:.1f} words/s; the call "
        f"{wall_b:.1f} s ({n_words / wall_b:.1f} words/s end to end), "
        f"{len(emb_b)} words kept")
    line = bench_item2vec.steady_line(w2v.words_trained, wall_a, n_words,
                                      W2V_ITERS, kw)
    log(f"[item2vec] bench_item2vec --quality (run A): {line}; at-scale "
        f"top-5 neighbor cluster purity: {purity:.3f}")

    # a profiled slice: the epoch over the corpus's first W2V_PROF_BLOCKS
    # blocks at run A's settings, on its trained tables
    counts = w2v.dictionary.counts_array()
    epoch, _, _ = w2v._epoch_fn(counts, dev)
    flat, doc_id = w2v._flatten_corpus(
        [np.asarray([w2v.dictionary.word2id[t] for t in d], np.int32)
         for d in docs[:2000]])
    bp = w2v._block_positions()
    n = W2V_PROF_BLOCKS * bp
    d_flat, d_doc = w2v._device_corpus(flat[:n], doc_id[:n], dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prof = profile_steps(torch, lambda i: epoch(
        d_flat, d_doc, 0.025, 0.02, w2v._draws(gen, i, 0, n)),
        "item2vec-profile", steps=2)
    blocks_ms = prof["wall_ms"] / W2V_PROF_BLOCKS

    err = check_w2v_card_vs_cpu(torch, dev)
    emb = store.embedding_map_from_model(w2v)
    check_searcher(torch, dev, emb)
    buf = io.StringIO()
    store.save_embedding_map(buf, emb)
    buf.seek(0)
    back = store.load_embedding_map(buf)
    require(list(back) == list(emb) and all(
        np.array_equal(back[w], emb[w]) for w in emb),
        "item2vec text round trip changed the map")
    log(f"[item2vec] text round trip of {len(emb)} × {emb.dim} exact "
        f"({len(buf.getvalue()) / 1e6:.2f} MB); profiled slice "
        f"{W2V_PROF_BLOCKS} blocks of {bp}: {blocks_ms:.4f} ms a block, "
        f"device busy {prof['busy_ms'] / W2V_PROF_BLOCKS:.4f} ms a block "
        f"(idle share {max(0.0, 1 - prof['busy_ms'] / prof['wall_ms']):.3f});"
        f" phase {time.perf_counter() - t_phase:.1f} s")
    del w2v, epoch, d_flat, d_doc
    torch.cuda.empty_cache()
    return {"words_per_s_a": rate_a, "pairs_per_s_a": pairs_a,
            "words_per_s_b": rate_b, "purity": purity, "peak_gb": peak,
            "idle": max(0.0, 1 - prof["busy_ms"] / prof["wall_ms"]),
            "card_vs_cpu": err}


# ------------------------------------------------------------ phase 11 --
def make_sales_workload(n, n_eval, seed=0):
    """Rows of examples/futuresales.py's feature layout (:98-109, 342
    columns: one-hots of day 31, month 12, year 3, date block 34, shop 60,
    category 84, weekday 7, a 10-bucket item hash, log2(price), a
    100-bucket name multihot of 3 tokens) with its planted signal
    (:45-86: sales ~ Poisson(category effect × shop effect × season ×
    20 / sqrt(price))) and its target scaling (count / 20). Returns (x,
    y) for training and held out."""
    rng = np.random.default_rng(seed)
    total = n + n_eval
    n_items, cats_n, shops_n, months_n = 400, 84, 60, 34
    cats = rng.integers(0, cats_n, n_items)
    cat_eff = rng.gamma(2.0, 2.0, cats_n)
    shop_eff = rng.uniform(0.5, 2.0, shops_n)
    prices = rng.uniform(2.0, 2000.0, n_items)
    name_tok = rng.integers(0, 100, (n_items, 3))
    item_hash = rng.integers(0, 10, n_items)
    items = rng.integers(0, n_items, total)
    shops = rng.integers(0, shops_n, total)
    blocks = rng.integers(0, months_n, total)
    months = blocks % 12
    season = 1.0 + 0.6 * np.cos(2 * np.pi * (months - 11) / 12.0)
    lam = (cat_eff[cats[items]] * shop_eff[shops] * season
           * (20.0 / np.sqrt(prices[items])))
    y = (rng.poisson(lam) / 20.0).astype(np.float32)
    x = np.zeros((total, 342), np.float32)
    rows = np.arange(total)
    col = 0
    for width, idx in ((31, rng.integers(0, 28, total)), (12, months),
                       (3, blocks // 12), (34, blocks), (60, shops),
                       (84, cats[items]), (7, rng.integers(0, 7, total)),
                       (10, item_hash[items])):
        x[rows, col + idx] = 1.0
        col += width
    x[:, col] = np.log2(prices[items])
    col += 1
    for j in range(3):
        x[rows, col + name_tok[items, j]] = 1.0
    return x[:n], y[:n], x[n:], y[n:]


def fit_timed(torch, model, x, y, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(x, y, **kw)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def check_mlp_card_vs_cpu(torch, dev):
    """Small f32 models trained on the card and on the CPU from the same
    parameters: the classifier with adam, lbfgs, bfgs and cg, the
    regressor (adam) and Neural; loss curves within MLP_LOSS_RTOL and
    parameters within TRAJ_TABLE_RTOL / TRAJ_TABLE_ATOL (lbfgs: its first
    MLP_LBFGS_TIGHT iterations; its line search branches on f32
    comparisons). Control: the card's classifier with one weight row
    written as the next row's."""
    from goctr_tpu_torch.models.mlp_classifier import MLPClassifier
    from goctr_tpu_torch.models.mlp_regressor import MLPRegressor
    from goctr_tpu_torch.models.neural import Neural, NeuralConfig

    rng = np.random.default_rng(SEED + 11)
    X = rng.normal(size=(1000, 12)).astype(np.float32)
    s = X[:, 0] + X[:, 1] ** 2 - 0.5 * X[:, 2]
    yc, yr = (s > 1).astype(np.int64), s.astype(np.float32)
    worst, ctl = [0.0, 0.0], None
    cases = [(MLPClassifier, yc, dict(solver=sv)) for sv in
             ("adam", "lbfgs", "bfgs", "cg")] + [(MLPRegressor, yr, {})]
    for cls, y, kw in cases:
        kw = dict(dict(hidden_layer_sizes=(16, 8), batch_size=100,
                       max_iter=6, shuffle=False, tol=0.0), **kw)
        init = cls(**kw, device="cpu").init_params(12, 1)
        out = {str(d): cls(**kw, device=d).fit(X, y, init=init)
               for d in ("cpu", dev)}
        c, g = out["cpu"], out[str(dev)]
        n = MLP_LBFGS_TIGHT if kw.get("solver") == "lbfgs" else None
        lc = np.abs(np.array(g.loss_curve_[:n]) - c.loss_curve_[:n]) / \
            np.abs(c.loss_curve_[:n])
        worst[0] = max(worst[0], float(lc.max()))
        what = f"small {cls.__name__} {kw.get('solver', 'adam')}"
        require(lc.max() <= MLP_LOSS_RTOL,
                f"{what}: loss curves differ by {lc.max():.3g}")
        if n is None:
            for a, b in zip(g.coefs_ + g.intercepts_,
                            c.coefs_ + c.intercepts_):
                bad, err = within(torch, torch.from_numpy(a),
                                  torch.from_numpy(b), TRAJ_TABLE_RTOL,
                                  TRAJ_TABLE_ATOL)
                worst[1] = max(worst[1], err)
                require(bad == 0, f"{what}: {bad} parameters outside")
        if ctl is None:
            wrong = g.coefs_[0].copy()
            wrong[0] = wrong[1]
            ctl = within(torch, torch.from_numpy(wrong), torch.from_numpy(
                c.coefs_[0]), TRAJ_TABLE_RTOL, TRAJ_TABLE_ATOL)
            require(ctl[0] > 0, f"small MLP control reads {ctl[1]}")
    cfg = NeuralConfig(inputs=12, layout=(16, 8, 1), activation="sigmoid",
                       mode="regression", loss="mse")
    curves = {str(d): Neural(cfg, seed=SEED, device=d).train(
        X, 1 / (1 + np.exp(-yr[:, None])), lr=0.05, epochs=2, batch_size=64,
        seed=1) for d in ("cpu", dev)}
    lc = np.abs(np.array(curves[str(dev)]) - curves["cpu"]) / np.abs(
        curves["cpu"])
    worst[0] = max(worst[0], float(lc.max()))
    require(lc.max() <= MLP_LOSS_RTOL, f"small Neural: {lc.max():.3g}")
    log(f"[mlp] small f32 models card vs CPU (classifier adam, lbfgs "
        f"(first {MLP_LBFGS_TIGHT} iterations), bfgs, cg; regressor; "
        f"Neural): max loss rel diff {worst[0]:.3g} (rtol {MLP_LOSS_RTOL}),"
        f" max parameter err {worst[1]:.3g} (rtol {TRAJ_TABLE_RTOL}, atol "
        f"{TRAJ_TABLE_ATOL}); control (a weight row written as the next "
        f"one's) {ctl[1]:.3g}")
    return worst


def mlp_phase(torch, dev):
    """Phase 11: the sklearn-style MLPs at full width: the classifier of
    the reference's main.go:42-47 ((100,), relu, adam, alpha 1e-5) on
    phase 9's 281-column planted rows, one epoch of sgd with Nesterov,
    full-batch lbfgs, bfgs and cg, the regressor and Neural at
    examples/futuresales.py's layouts and 342 columns, and small models
    card vs CPU. Returns the readings."""
    from goctr_tpu_torch.core.metrics import r2_score, roc_auc_score
    from goctr_tpu_torch.models.mlp_classifier import MLPClassifier
    from goctr_tpu_torch.models.mlp_regressor import MLPRegressor
    from goctr_tpu_torch.models.neural import Neural, NeuralConfig

    t_phase = time.perf_counter()
    sample, x_ev, y_ev, _, _ = make_dense_workload(
        MLP_ROWS, MLP_EVAL_ROWS, seed=SEED + 12)
    x, y = sample.x, sample.y.astype(np.int64)
    readings = {}
    steps = -(-MLP_ROWS // 200)
    clf, secs = fit_timed(torch, MLPClassifier(
        (100,), "relu", "adam", alpha=1e-5, max_iter=MLP_EPOCHS,
        random_state=SEED, device=dev), x, y)
    auc = roc_auc_score(y_ev, clf.predict_proba(x_ev)[:, 1])
    lc = clf.loss_curve_
    require(all(np.isfinite(lc)) and lc[-1] < lc[0],
            f"MLPClassifier adam: the loss does not fall {lc}")
    require(auc > MLP_AUC_MIN, f"MLPClassifier held-out AUC {auc}")
    readings["adam"] = dict(ex_s=MLP_ROWS * MLP_EPOCHS / secs,
                            step_ms=secs / (steps * MLP_EPOCHS) * 1e3,
                            auc=auc)
    sgd, secs = fit_timed(torch, MLPClassifier(
        (100,), "relu", "sgd", alpha=1e-5, max_iter=1, random_state=SEED,
        nesterovs_momentum=True, device=dev), x, y)
    readings["sgd"] = dict(ex_s=MLP_ROWS / secs, step_ms=secs / steps * 1e3,
                           loss=sgd.loss_curve_[0])
    log(f"[mlp] MLPClassifier((100,), relu, adam, alpha 1e-5) on "
        f"{MLP_ROWS} × {x.shape[1]} rows, batch 200 ({steps} steps), "
        f"{MLP_EPOCHS} epochs: loss {lc}, {readings['adam']['ex_s']:.1f} "
        f"ex/s, {readings['adam']['step_ms']:.4f} ms a step (the whole fit),"
        f" held-out AUC {auc:.6f} on {MLP_EVAL_ROWS} rows (limit "
        f"{MLP_AUC_MIN}); sgd + Nesterov one epoch: loss "
        f"{sgd.loss_curve_[0]:.6f}, {readings['sgd']['ex_s']:.1f} ex/s")
    for solver in ("lbfgs", "bfgs", "cg"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 1e9
        m, secs = fit_timed(torch, MLPClassifier(
            (100,), "relu", solver, alpha=1e-5, max_iter=MLP_FULLBATCH_ITERS,
            tol=0.0, random_state=SEED, device=dev), x, y)
        peak = torch.cuda.max_memory_allocated() / 1e9 - held
        lc = m.loss_curve_
        require(all(np.isfinite(lc)) and lc[-1] < lc[0],
                f"MLPClassifier {solver}: the loss does not fall {lc}")
        auc = roc_auc_score(y_ev, m.predict_proba(x_ev)[:, 1])
        readings[solver] = dict(s_iter=secs / m.n_iter_, peak_gb=peak,
                                auc=auc, loss=lc)
        log(f"[mlp] {solver} full batch ({MLP_ROWS} rows, "
            f"{sum(w.size for w in m.coefs_ + m.intercepts_)} parameters): "
            f"{m.n_iter_} iterations, {secs / m.n_iter_:.4f} s an "
            f"iteration, loss {[round(v, 6) for v in lc]}, held-out AUC "
            f"{auc:.6f}, peak device memory {peak:.3f} GB above {held:.2f}")
    xs, ys, xs_ev, ys_ev = make_sales_workload(SALES_ROWS, SALES_EVAL_ROWS,
                                               seed=SEED + 13)
    reg, secs = fit_timed(torch, MLPRegressor(
        (64, 64), "relu", "adam", batch_size=256, max_iter=SALES_EPOCHS,
        random_state=SEED, device=dev), xs, ys)
    r2_reg = r2_score(ys_ev, reg.predict(xs_ev))
    readings["regressor"] = dict(ex_s=SALES_ROWS * SALES_EPOCHS / secs,
                                 r2=r2_reg)
    net = Neural(NeuralConfig(inputs=xs.shape[1], layout=(64, 64, 1),
                              activation="sigmoid", mode="regression",
                              loss="mse"), seed=SEED, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    curve = net.train(xs, ys, lr=0.05, epochs=SALES_EPOCHS, batch_size=64)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    r2_net = r2_score(ys_ev, net.predict(xs_ev)[:, 0])
    readings["neural"] = dict(ex_s=SALES_ROWS * SALES_EPOCHS / secs,
                              r2=r2_net)
    require(r2_reg > 0 and r2_net > 0,
            f"R² must exceed 0: regressor {r2_reg}, Neural {r2_net}")
    log(f"[mlp] futuresales layout ({SALES_ROWS} × {xs.shape[1]}, "
        f"{SALES_EPOCHS} epochs, held-out {SALES_EVAL_ROWS}): MLPRegressor "
        f"(64, 64) adam batch 256: loss {reg.loss_curve_}, "
        f"{readings['regressor']['ex_s']:.1f} ex/s, R² {r2_reg:.6f}; Neural "
        f"[342, 64, 64, 1] sigmoid mse lr 0.05 batch 64: loss {curve}, "
        f"{readings['neural']['ex_s']:.1f} ex/s, R² {r2_net:.6f}")
    readings["card_vs_cpu"] = check_mlp_card_vs_cpu(torch, dev)
    log(f"[mlp] phase {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return readings


# ------------------------------------------------------------ phase 12 --
# phase 12, the product path of goctr_tpu_torch/main.py: a database made by
# the port's fixture generator at MovieLens-1M's user and movie counts
# (6,040 × 3,706) with 100,000 ratings, seed 7 (~80k training rows, which
# fill main.py's sample_cnt=80000); rows of 281 columns, phase 9's ML-20M
# layout (52 user, 10 × 16 behaviors, 16 item embedding, 53 item features)
PIPE_FIXTURE = dict(n_users=6040, n_movies=3706, n_ratings=100_000, seed=7)
PIPE_SAMPLE_CNT = 80_000
PIPE_DIN_EPOCHS = 3
# held-out AUC of main.py's MLP over ratings_test (the JAX package's bar on
# its 200-user test fixture is 0.8811 ± 0.02, tests/test_movielens.py)
PIPE_AUC_MIN = 0.75
PIPE_CLIENTS, PIPE_REQUESTS, PIPE_CANDS = 16, 25, 100
PIPE_CARD_VS_CPU_ROWS = 4096
PIPE_PROFILED_CALLS = 5
PIPE_CONTROL_SHIFT = 0.05          # added to the output bias (control)
PIPE_CLI_TIMEOUT_S = 300


@contextlib.contextmanager
def timed_calls(torch, *targets):
    """Within the block, each call of getattr(obj, name) for (obj, name)
    in targets is timed to its end (a device sync after it): yields
    {"s": seconds summed by name, "out": the last result by name}."""
    from unittest import mock

    rec = {"s": {}, "out": {}}

    def wrap(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            rec["s"][name] = rec["s"].get(name, 0.0) + time.perf_counter() - t0
            rec["out"][name] = out
            return out
        return run

    with contextlib.ExitStack() as stack:
        for obj, name in targets:
            stack.enter_context(mock.patch.object(
                obj, name, wrap(name, getattr(obj, name))))
        yield rec


def post_json(url, body, timeout=60):
    """(status, parsed body) of a JSON POST; 4xx/5xx answers included."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get_url(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        require(resp.status == 200, f"GET {url}: {resp.status}")
        return resp.read()


def main_trainer_config(cfg):
    """The TrainerConfig goctr_tpu_torch/main.py builds from a Config."""
    from goctr_tpu_torch.models.trainer import TrainerConfig

    return TrainerConfig(
        batch_size=cfg.optim.batch_size, epochs=cfg.optim.max_iter,
        early_stop=cfg.optim.early_stop_patience, solver=cfg.optim.solver,
        lr=cfg.optim.lr, lr_schedule=cfg.optim.lr_schedule,
        l2=cfg.optim.alpha, weight_decay=cfg.optim.weight_decay,
        seed=cfg.seed, verbose=cfg.verbose)


def pipeline_train(torch, dev, db, name, tc, use_bf16, model_kw, tag):
    """Train(..., device=dev) on MovielensRec(db), each stage timed:
    pre_train, item2vec (the item-sequence SQL read included), sample
    assembly and the fit; peak device memory above what was held before.
    Returns (predictor, the assembled sample, readings)."""
    from goctr_tpu_torch.data.movielens import MovielensRec
    from goctr_tpu_torch.recommend import rcmd

    rec = MovielensRec(db, sample_cnt=PIPE_SAMPLE_CNT)
    fitter = rcmd.RankerFitter(name, tc, use_bf16=use_bf16, device=dev,
                               **model_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9
    with timed_calls(torch, (rec, "pre_train"), (rcmd, "train_embedding"),
                     (rcmd, "get_sample"), (fitter, "fit")) as t:
        t0 = time.perf_counter()
        pred = rcmd.Train(rcmd.Context(), rec, fitter, device=dev)
        total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 - held
    sample, r, s = t["out"]["get_sample"], pred.model, t["s"]
    require(sample.x.shape[1] == ml20m_info().width,
            f"{tag}: assembled rows have {sample.x.shape[1]} columns")
    lc = r.loss_curve
    require(all(np.isfinite(lc)) and lc[-1] < lc[0],
            f"{tag}: the loss does not fall {lc}")
    steps = -(-sample.rows // tc.batch_size)
    later = r.epoch_times[1:]
    out = {"rows": sample.rows, "total_s": total, "peak_gb": peak,
           "pre_train_s": s["pre_train"], "item2vec_s": s["train_embedding"],
           "words": len(pred.item_embedding_map),
           "assembly_s": s["get_sample"],
           "assembly_rows_per_s": sample.rows / s["get_sample"],
           "fit_s": s["fit"], "epochs": len(lc),
           "fit_ex_per_s": sample.rows * len(later) / sum(later),
           "step_ms": sum(later) / (steps * len(later)) * 1e3}
    log(f"[{tag}] Train on {db.rsplit('/', 1)[-1]}: {out['rows']} rows × "
        f"{sample.x.shape[1]} columns, positive rate {sample.y.mean():.4f};"
        f" s: pre_train {out['pre_train_s']:.3f}, item2vec "
        f"{out['item2vec_s']:.3f} ({out['words']} words), assembly "
        f"{out['assembly_s']:.3f} ({out['assembly_rows_per_s']:.1f} rows/s),"
        f" fit {out['fit_s']:.3f} ({out['epochs']} epochs of {steps} steps: "
        f"{out['fit_ex_per_s']:.1f} ex/s, {out['step_ms']:.4f} ms a step "
        f"over epochs 2-), Train {total:.3f}; loss curve "
        f"{[round(x, 6) for x in lc]}; peak device memory {peak:.3f} GB "
        f"above the {held:.3f} GB earlier phases hold")
    return pred, sample, out


def pipeline_eval(pred, test, tag):
    """Held-out AUC and GAUC of BatchPredict over the test samples."""
    from goctr_tpu_torch.core.metrics import gauc, roc_auc_score
    from goctr_tpu_torch.recommend import rcmd

    t0 = time.perf_counter()
    scores = rcmd.BatchPredict(rcmd.Context(), pred, test)
    dt = time.perf_counter() - t0
    y = np.asarray([k.label for k in test], np.float32)
    users = np.asarray([k.user_id for k in test])
    require(scores.shape == y.shape and np.isfinite(scores).all(),
            f"{tag}: BatchPredict scores {scores.shape}, finite "
            f"{np.isfinite(scores).all()}")
    auc, g = roc_auc_score(y, scores), gauc(y, scores, users)
    log(f"[{tag}] held-out BatchPredict over ratings_test: {len(test)} rows "
        f"of {len(np.unique(users))} users in {dt:.3f} s; AUC {auc:.6f}, "
        f"GAUC {g:.6f}")
    return scores, auc, g


def pipeline_card_vs_cpu(torch, pred, test):
    """The card's BatchPredict scores against the same parameters' on the
    CPU (same keys, same features), within phase 9's bf16 limit; a control
    with the output bias shifted by PIPE_CONTROL_SHIFT must exceed it."""
    import dataclasses

    from goctr_tpu_torch.models.trainer import _params_on
    from goctr_tpu_torch.recommend import rcmd

    keys = test[:PIPE_CARD_VS_CPU_ROWS]
    r = pred.model
    cpu_params = _params_on(r.params, torch.device("cpu"))
    ctl_params = _params_on(cpu_params, torch.device("cpu"))
    ctl_params["bias"][-1] += PIPE_CONTROL_SHIFT
    got = rcmd.BatchPredict(rcmd.Context(), pred, keys)
    atol, rtol = TOL["bfloat16"]
    out = {}
    for what, params in (("cpu", cpu_params), ("control", ctl_params)):
        on_cpu = dataclasses.replace(pred, model=dataclasses.replace(
            r, params=params, opt_state=None))
        want = rcmd.BatchPredict(rcmd.Context(), on_cpu, keys)
        diff = np.abs(got - want)
        out[what] = (int((diff > atol + rtol * np.abs(want)).sum()),
                     float(diff.max()))
    require(out["cpu"][0] == 0,
            f"pipeline card vs CPU: {out['cpu'][0]} scores outside atol "
            f"{atol} + rtol {rtol} (max diff {out['cpu'][1]:.3g})")
    require(out["control"][0] > 0, "pipeline card vs CPU control: the "
                                   "shifted output bias passes the limit")
    log(f"[pipeline] card vs CPU BatchPredict, same parameters, "
        f"{len(keys)} held-out rows, bf16: max diff {out['cpu'][1]:.3g} "
        f"(atol {atol} + rtol {rtol}); control (output bias + "
        f"{PIPE_CONTROL_SHIFT}): {out['control'][0]} scores outside, max "
        f"diff {out['control'][1]:.3g}")
    return out["cpu"][1]


def rank_pool_inputs(torch, pred, user, items):
    """K2's inputs on the Rank path: the rows BatchPredict assembles for
    one user's candidates, padded to predict's bucket, split and cast as
    DIN "pallas" passes them to the pool."""
    from goctr_tpu_torch.models.base import split_blocks
    from goctr_tpu_torch.models.trainer import _bucket
    from goctr_tpu_torch.recommend import rcmd

    r = pred.model
    ctx = rcmd.Context(rcmd.Stage.PREDICT)
    n = len(items)
    x = rcmd._assemble_batch(ctx, pred.state, pred.rec_sys,
                             np.full(n, user, np.int64),
                             np.asarray(items, np.int64),
                             np.full(n, int(time.time()), np.int64))
    chunk = np.zeros((_bucket(n), x.shape[1]), np.float32)
    chunk[:n] = x
    _, beh, item, _ = split_blocks(torch.from_numpy(chunk).to(r.device),
                                   r.info, r.behavior_len)
    cd = r.model.compute_dtype
    return (beh.to(cd).contiguous(), item.to(cd).contiguous(),
            r.params["att0"].to(cd).float(),
            torch.ones(beh.shape[:2], device=r.device))


def pipeline_http(torch, pred, test_users, n_items):
    """RecApiServer on `pred` (no rank_direct: the Rank path) answering
    PIPE_CLIENTS concurrent clients × PIPE_REQUESTS requests of PIPE_CANDS
    candidates; the dashboard's endpoints and page. Returns latencies."""
    from goctr_tpu_torch.recommend import rcmd
    from goctr_tpu_torch.serve.api import RecApiServer

    rng = np.random.default_rng(SEED + 12)
    reqs = [(int(rng.choice(test_users)), [int(i) for i in rng.choice(
        np.arange(1, n_items + 1), PIPE_CANDS, replace=False)])
        for _ in range(PIPE_CLIENTS * PIPE_REQUESTS)]
    srv = RecApiServer(pred, host="127.0.0.1", port=0).start(background=True)
    base = f"http://127.0.0.1:{srv.port}"
    url = f"{base}/api/v1/recommend"
    lat, bad = [], []

    def client(c):
        for u, items in reqs[c * PIPE_REQUESTS:(c + 1) * PIPE_REQUESTS]:
            t0 = time.perf_counter()
            try:
                status, out = post_json(url, {"userId": u,
                                              "itemIdList": items})
            except OSError as e:
                bad.append(repr(e))
                continue
            lat.append(time.perf_counter() - t0)
            lst = out.get("itemScoreList", [])
            if (status != 200 or [e["itemId"] for e in lst] != items
                    or not all(0.0 <= e["score"] <= 1.0 for e in lst)):
                bad.append((u, status, str(out)[:200]))

    try:
        status, first = post_json(url, {"userId": reqs[0][0],
                                        "itemIdList": reqs[0][1]})
        require(status == 200, f"pipeline http: first request {status} "
                               f"{first}")
        want = [s.score for s in rcmd.Rank(rcmd.Context(), pred, reqs[0][0],
                                           reqs[0][1])]
        err = float(np.abs(np.array([e["score"] for e in first[
            "itemScoreList"]]) - want).max())
        require(err <= 1e-6, f"pipeline http: scores differ from Rank by "
                             f"{err:.3g}")
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(PIPE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        require(not any(t.is_alive() for t in threads),
                "pipeline http: a client did not finish")
        require(not bad and len(lat) == len(reqs),
                f"pipeline http: {len(bad)} bad answers, e.g. {bad[:2]}")
        require(post_json(url, {"userId": 10 ** 9, "itemIdList": [1]})
                == (400, {"error": f"userId {10 ** 9} not found",
                          "userId": 10 ** 9}),
                "pipeline http: an unknown user must get 400 naming it")
        ov = json.loads(get_url(f"{base}/service/overview"))
        require(ov["users"] == PIPE_FIXTURE["n_users"]
                and ov["items"] == PIPE_FIXTURE["n_movies"],
                f"pipeline http: overview {ov}")
        for kind in ("items", "users"):
            fd = json.loads(get_url(f"{base}/service/featuredist?kind={kind}"))
            require(fd["kind"] == kind and fd["sampled"] > 0
                    and {"avg_rating", "cnt_rating", "genre_active_dims"}
                    <= {f["feature"] for f in fd["features"]},
                    f"pipeline http: featuredist {kind}")
        html = get_url(f"{base}/").decode()
        require("dashboard" in html.lower() and "#/overview" in html,
                "pipeline http: / does not serve the dashboard")
    finally:
        srv.stop()
    p50, p99 = np.percentile(np.array(lat) * 1e3, [50, 99])
    log(f"[pipeline-http] {PIPE_CLIENTS} clients × {PIPE_REQUESTS} POST "
        f"/api/v1/recommend × {PIPE_CANDS} candidates through Rank in "
        f"{wall:.3f} s ({len(lat) / wall:.1f} requests/s, "
        f"{len(lat) * PIPE_CANDS / wall:.1f} scores/s): latency p50 "
        f"{p50:.3f} ms, p99 {p99:.3f} ms, max {max(lat) * 1e3:.3f} ms; "
        f"first answer equals Rank (max diff {err:.3g}); overview, "
        f"featuredist, the dashboard and an unknown user's 400 checked")
    return {"p50_ms": p50, "p99_ms": p99, "rps": len(lat) / wall}


def profile_rank(torch, pred, user, items):
    """Where one BatchPredict of len(items) candidates spends its time:
    the SQL feature fetch, row assembly and the model's predict (host
    clock, each call ended by a sync), with cold caches and warm; then
    PIPE_PROFILED_CALLS warm calls under torch.profiler (taken again if it
    recorded no device event: it loses events): host-to-device copies,
    device busy time and the idle share, a call."""
    from torch.profiler import ProfilerActivity, profile

    from goctr_tpu_torch.recommend import rcmd

    now = int(time.time())
    keys = [rcmd.Sample(user_id=user, item_id=i, timestamp=now)
            for i in items]
    out = {}
    for label in ("cold", "warm"):
        if label == "cold":
            pred.state.user_cache.clear()
            pred.state.item_cache.clear()
        with timed_calls(torch, (rcmd, "_fetch_features_unique"),
                         (rcmd, "_assemble_rows"), (pred.model, "predict")
                         ) as t:
            t0 = time.perf_counter()
            rcmd.BatchPredict(rcmd.Context(), pred, keys)
            wall = time.perf_counter() - t0
        out[label] = dict(wall_ms=wall * 1e3, **{
            k: v * 1e3 for k, v in t["s"].items()})
    for _ in range(5):          # a profile that recorded nothing: again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PIPE_PROFILED_CALLS):
                rcmd.BatchPredict(rcmd.Context(), pred, keys)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / PIPE_PROFILED_CALLS
        rows = [(us / PIPE_PROFILED_CALLS, count, key)
                for us, count, key in device_events(prof)]
        if rows:
            break
    require(bool(rows), "pipeline profile: no device event recorded")
    busy = sum(r[0] for r in rows)
    h2d = sum(us for us, _, key in rows if "HtoD" in key)
    d2h = sum(us for us, _, key in rows if "DtoH" in key)
    for label, r in out.items():
        fetch, asm, pr = (r["_fetch_features_unique"], r["_assemble_rows"],
                          r["predict"])
        log(f"[pipeline-profile] BatchPredict of {len(items)} candidates, "
            f"{label} caches: wall {r['wall_ms']:.3f} ms; SQL feature fetch "
            f"{fetch:.3f}, assembly (native gathers) {asm:.3f}, predict "
            f"{pr:.3f}, the rest {r['wall_ms'] - fetch - asm - pr:.3f}")
    log(f"[pipeline-profile] profiled warm calls ({PIPE_PROFILED_CALLS}), "
        f"each: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.4f} ms (idle share "
        f"{max(0.0, 1 - busy / wall_us):.4f}): host-to-device copy "
        f"{h2d / 1e3:.4f}, device-to-host {d2h / 1e3:.4f}, kernels "
        f"{(busy - h2d - d2h) / 1e3:.4f}")
    for us, count, key in rows[:10]:
        log(f"[pipeline-profile]   device {us / 1e3:9.4f} ms a call  "
            f"x{count // PIPE_PROFILED_CALLS:<3d} {key[:90]}")
    out["busy_ms"], out["idle"] = busy / 1e3, max(0.0, 1 - busy / wall_us)
    return out


def pipeline_cli(db, user, workdir):
    """`python -m goctr_tpu_torch.main --data.dsn=db --optim.max_iter=2
    --serve.port=<free>` as a subprocess: it must answer one POST, then it
    is stopped. Returns seconds from start to the first answer."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "goctr_tpu_torch.main", f"--data.dsn={db}",
           "--optim.max_iter=2", f"--serve.port={port}"]
    log_path = os.path.join(workdir, "cli.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(os.path.abspath(
                                    __file__)))
        try:
            answer = None
            while answer is None:
                if proc.poll() is not None:
                    with open(log_path) as f:
                        tail = f.read()[-3000:]
                    raise RuntimeError(f"check failed: the CLI exited "
                                       f"{proc.returncode} before serving: "
                                       f"{tail}")
                require(time.perf_counter() - t0 < PIPE_CLI_TIMEOUT_S,
                        f"CLI did not serve within {PIPE_CLI_TIMEOUT_S} s")
                try:
                    answer = post_json(f"http://127.0.0.1:{port}/api/v1/"
                                       f"recommend", {"userId": user,
                                                      "itemIdList": [1, 2]},
                                       timeout=30)
                except (urllib.error.URLError, ConnectionError):
                    time.sleep(0.5)
            ready = time.perf_counter() - t0
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    status, out = answer
    require(status == 200 and len(out["itemScoreList"]) == 2,
            f"CLI answered {status} {out}")
    log(f"[pipeline-cli] {' '.join(cmd[1:4])} ... answered POST "
        f"/api/v1/recommend {ready:.1f} s after start ({out}); stopped")
    return ready


def pipeline_phase(torch, dev):
    """Phase 12: the product path of goctr_tpu_torch/main.py on the card.
    A fixture database at PIPE_FIXTURE; (1) main.py's configuration
    (Config() defaults: MLP (100,) relu, adam 1e-3, batch 200, 20 epochs,
    early stop 10, alpha 1e-5, seed 42, bf16) through Train on the card:
    stage seconds, fit rate, peak memory, held-out AUC/GAUC over
    ratings_test, card vs CPU with a control; (2) the same pipeline with
    DIN "pallas" for PIPE_DIN_EPOCHS epochs — the main path of K2 (fit
    forward, BatchPredict, Rank) and K2b (fit backward), counts reset just
    before and read just after; K2 held against its plain version on the
    Rank path's own inputs and K2/K2b on the fit's first step, with
    controls, and timed; (3) HTTP through the Rank path with concurrent
    clients, the dashboard endpoints and a profiled BatchPredict; (4) the
    CLI as a subprocess. Returns the kernels-line entries and readings."""
    import dataclasses
    import sqlite3
    import tempfile

    from goctr_tpu_torch.core.config import Config
    from goctr_tpu_torch.data.fixture import generate_movielens_fixture
    from goctr_tpu_torch.ops.kernels import din_attention as k2
    from goctr_tpu_torch.recommend import rcmd

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        db = f"{tmp}/movielens.db"
        t0 = time.perf_counter()
        generate_movielens_fixture(db, **PIPE_FIXTURE)
        with sqlite3.connect(db) as conn:
            n_train = conn.execute(
                "SELECT count(*) FROM ratings_train").fetchone()[0]
            test_users = [u for (u,) in conn.execute(
                "SELECT userId FROM user_feature_test")]
        log(f"[pipeline] fixture {PIPE_FIXTURE} in "
            f"{time.perf_counter() - t0:.1f} s: {n_train} ratings_train "
            f"rows, {len(test_users)} test users")

        # (1) main.py's configuration
        cfg = Config()
        tc = main_trainer_config(cfg)
        mlp, _, r_mlp = pipeline_train(
            torch, dev, db, cfg.model.name, tc, cfg.model.use_bf16,
            dict(hidden=tuple(cfg.model.hidden),
                 activation=cfg.model.activation), "pipeline")
        test = mlp.rec_sys.test_samples()
        _, r_mlp["auc"], r_mlp["gauc"] = pipeline_eval(mlp, test, "pipeline")
        require(r_mlp["auc"] > PIPE_AUC_MIN,
                f"pipeline MLP held-out AUC {r_mlp['auc']} <= {PIPE_AUC_MIN}")
        r_mlp["card_vs_cpu"] = pipeline_card_vs_cpu(torch, mlp, test)

        # (2) DIN "pallas": the main path of K2 and K2b
        counted = (k2.din_attention_pool, k2.din_attention_pool_bwd)
        for f in counted:
            f.launches = 0
        din, din_sample, r_din = pipeline_train(
            torch, dev, db, "din",
            dataclasses.replace(tc, epochs=PIPE_DIN_EPOCHS),
            cfg.model.use_bf16, dict(attention_impl="pallas"),
            "pipeline-din")
        _, r_din["auc"], r_din["gauc"] = pipeline_eval(din, test,
                                                       "pipeline-din")
        user = int(test_users[0])
        items = list(range(1, PIPE_CANDS + 1))
        ranked = rcmd.Rank(rcmd.Context(), din, user, items)
        require(len(ranked) == PIPE_CANDS and all(
            0.0 <= s.score <= 1.0 for s in ranked), "pipeline DIN Rank")
        launches = {f.__name__: f.launches for f in counted}
        require(all(launches.values()),
                f"pipeline DIN: a kernel of the path was never launched "
                f"{launches}")
        # K2 on the Rank path's own inputs, with a control
        inp = rank_pool_inputs(torch, din, user, items)
        got = k2.din_attention_pool(*inp)
        want = k2.din_attention_pool_plain(*inp)
        torch.cuda.synchronize()
        errs = {"K2 rank": max_err(torch, got, want, "bfloat16",
                                   "K2 pipeline Rank")}
        atol, rtol = TOL["bfloat16"]
        rank_ctl, _ = within(torch, torch.zeros_like(want), want, rtol, atol)
        require(rank_ctl > 0, "pipeline K2 control: a zeroed pool passes")
        B, T, D = inp[0].shape
        nb, nf, _, _ = pool_bounds(B, T, D)
        rank_k2 = dict(ms=device_ms(torch, lambda i: k2.din_attention_pool(
            *inp), 1), plain_ms=device_ms(
            torch, lambda i: k2.din_attention_pool_plain(*inp), 1, iters=6))
        rank_k2["bound_ms"], rank_k2["bound_by"] = bound(nb, nf)
        log(f"[pipeline-kernels] K2 on the Rank path's inputs B,T,D=({B}, "
            f"{T}, {D}) bf16, no mask: max err {errs['K2 rank']:.3g} (tol "
            f"atol={atol} rtol={rtol}), a zeroed pool leaves {rank_ctl} "
            f"entries outside; device ms per call: kernel "
            f"{rank_k2['ms']:.5f}, plain {rank_k2['plain_ms']:.5f}, bound "
            f"{rank_k2['bound_ms']:.5f} ({nb} B, {rank_k2['bound_by']})")
        # K2 and K2b on the fit's first step (B = batch 200)
        step = dense_first_step(torch, din.model.model, din_sample,
                                dataclasses.replace(
                                    tc, epochs=PIPE_DIN_EPOCHS), dev)
        fit_errs, fit_ctl = check_dense_kernels(torch, step,
                                                "pipeline-kernels")
        errs.update(fit_errs)
        times = time_dense_kernels(torch, step, "pipeline-kernels")
        del step, din_sample
        log(f"[pipeline-din] launches on the main path (Train, BatchPredict"
            f" over ratings_test, one Rank): {launches}")

        # (3) HTTP through the Rank path, on main.py's MLP
        http = pipeline_http(torch, mlp, test_users,
                             PIPE_FIXTURE["n_movies"])
        prof = profile_rank(torch, mlp, user, items)

        # (4) the CLI
        cli_s = pipeline_cli(db, user, tmp)
    del mlp, din
    torch.cuda.empty_cache()
    # (5) python -m goctr_tpu_torch.bench_serving at its defaults
    served = bench_serving.run(device=dev)
    for line in bench_serving.lines(served):
        log(f"[bench-serving] {line}")
    require(served["scores"] == served["requests"] * served["items"],
            f"bench_serving: {served['scores']} scores for "
            f"{served['requests']} requests of {served['items']} items")
    torch.cuda.empty_cache()
    log(f"[pipeline] done in {time.perf_counter() - t_phase:.1f} s")
    entries = []
    for key, name, src, replaces, count in (
            ("K2", "din_attention (pipeline DIN)", "din_attention.cu",
             "goctr_tpu/ops/pallas/din_attention.py:97",
             "din_attention_pool"),
            ("K2b", "din_attention_bwd (pipeline DIN)",
             "din_attention_bwd.cu", "goctr_tpu/parallel/sparse_ctr.py:128",
             "din_attention_pool_bwd")):
        r = times[key]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"goctr_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[count],
            "max_abs_err": max(v for k, v in errs.items()
                               if k.split()[0] == key),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    return entries, {"mlp": r_mlp, "din": r_din, "http": http,
                     "profile": prof, "cli_s": cli_s, "rank_k2": rank_k2,
                     "bench_serving": served,
                     "controls": dict(fit_ctl, rank=rank_ctl)}


# ------------------------------------------------------------ phase 13 --
# The ML-20M-statistics protocol (scripts/parity_ml20m_torch.py) at a cut
# scale: 0.05 of ML-20M's users and movies (6,924 × 1,337, ~1.1M ratings;
# 720,000 training rows, 280,500 test rows asked for), the signal knobs of
# PARITY_ML20M_r05_scale01.json (those that differ from SignalKnobs()).
ML20M_SCALE = 0.05
ML20M_KNOBS = dict(beta=0.45, noise=1.0, p_stay=0.7, p_follow=0.6,
                   p_chain=0.55, beta_item=2.5, chain_w=10, latent_dim=16,
                   latent_genre_w=0.6, item_thr=0.5)
ML20M_FLAGS = ["--epochs=3", "--batch=16384", "--seq_act=relu",
               "--attention_impl=pallas"]
# Held-out AUC of the JAX package's own runs of this configuration on the
# CPU, the lowest of seeds 0-4: python scripts/parity_ml20m.py --cpu
# --scale=0.05 --set <each knob above> --epochs=3 --batch=16384
# --seq_act=relu --seed=<0-4> read mlp 0.702105, 0.678268, 0.685585,
# 0.692400, 0.686352; youtube 0.731668, 0.727832, 0.707780, 0.691689,
# 0.723947; din 0.731510, 0.722437, 0.703372, 0.688363, 0.726002. After
# 132 steps the seed alone moves an AUC by up to 0.04 in either package
# (the port's CPU runs of seeds 0-4 read din 0.702714-0.731847), so a bar
# taken from one seed would fail on the draw, not on the port.
ML20M_JAX_AUC = {"mlp": 0.678268, "youtube": 0.691689, "din": 0.688363}
ML20M_AUC_MARGIN = 0.02             # each model's bar: JAX's AUC − this


def parity_script():
    """scripts/parity_ml20m_torch.py as a module (its stages and flags)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "scripts" / \
        "parity_ml20m_torch.py"
    spec = importlib.util.spec_from_file_location("parity_ml20m_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ml20m_phase(torch, dev):
    """Phase 13: the ML-20M-statistics protocol on the card, through
    scripts/parity_ml20m_torch.py's stages. The fixture generated at
    ML20M_SCALE with ML20M_KNOBS (goctr_tpu_torch/data/ml20m.py), then
    pre_train, item2vec on the card, get_sample and the test slice's
    assembly (`prepare`), each timed; MLP, YouTube-DNN and DIN "pallas"
    fitted by RankerFitter with the script's TrainerConfig (3 epochs,
    batch 16,384, f16 storage, bf16, relu towers) and scored on the test
    slice by the device AUC/GAUC, each AUC above its bar (JAX's lowest
    reading of five seeds on the CPU − ML20M_AUC_MARGIN; control: DIN's
    scores against shuffled labels must not clear it). K2 / K2b launches reset just before the
    DIN fit and read after its predict; both held against their plain
    versions on the fit's first step with phase 9's limits and controls,
    and timed; a profiled DIN step. Returns the kernels-line entries and
    readings."""
    import dataclasses
    import tempfile

    from goctr_tpu_torch.core.metrics import gauc_device, roc_auc_device
    from goctr_tpu_torch.data.ml20m import SignalKnobs, generate_ml20m_fixture
    from goctr_tpu_torch.ops.kernels import din_attention as k2
    from goctr_tpu_torch.recommend.rcmd import RankerFitter

    t_phase = time.perf_counter()
    script = parity_script()
    args = script.parse_args([f"--scale={ML20M_SCALE}"] + ML20M_FLAGS)
    out = {"timings": {}}
    with tempfile.TemporaryDirectory() as tmp:
        db = f"{tmp}/ml20m.db"
        t0 = time.perf_counter()
        stats = generate_ml20m_fixture(
            db, scale=ML20M_SCALE, knobs=SignalKnobs(**ML20M_KNOBS),
            oversample=args.oversample)
        out["timings"]["generate_s"] = time.perf_counter() - t0
        sample, x_test, te_y, te_uid = script.prepare(
            db, args.sample_cnt, args.test_cnt, dev, out["timings"])
    tm = out["timings"]
    log(f"[ml20m] fixture scale {ML20M_SCALE}: {stats['n_users']} users × "
        f"{stats['n_movies']} movies, {stats['n_ratings']} ratings (positive"
        f" rate {stats['pos_rate']:.4f}); s: generation "
        f"{tm['generate_s']:.3f}, pre_train {tm['pre_train_s']:.3f}, "
        f"item2vec {tm['item2vec_s']:.3f}, assembly {tm['assembly_s']:.3f} "
        f"({sample.rows / tm['assembly_s']:.1f} rows/s: {sample.rows} × "
        f"{sample.x.shape[1]}), test assembly {tm['test_assembly_s']:.3f} "
        f"({x_test.shape[0]} rows, positive rate {te_y.mean():.4f})")
    require(sample.x.shape[1] == ml20m_info().width and sample.rows > 0
            and np.isfinite(sample.x).all() and np.isfinite(x_test).all(),
            f"ml20m: assembled {sample.x.shape} / {x_test.shape}")
    y_dev = torch.from_numpy(te_y).to(dev)
    u_dev = torch.from_numpy(np.asarray(te_uid)).to(dev)
    steps = -(-sample.rows // args.batch)
    counted = (k2.din_attention_pool, k2.din_attention_pool_bwd)
    rankers, readings = {}, {}
    for name in ("mlp", "youtube", "din"):
        cfg = script.trainer_config(name, args.epochs, args)
        fitter = RankerFitter(name, cfg, use_bf16=True, device=dev,
                              **script.model_kwargs(name, args))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 1e9
        if name == "din":               # the main path of K2 and K2b
            for f in counted:
                f.launches = 0
        t0 = time.perf_counter()
        r = fitter.fit(sample)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        if name == "din":
            fit_launches = {f.__name__: f.launches for f in counted}
        t0 = time.perf_counter()
        scores = torch.from_numpy(r.predict(x_test, batch_size=args.pred_bs)
                                  ).to(dev)
        auc = float(roc_auc_device(scores, y_dev))
        g = float(gauc_device(scores, y_dev, u_dev))
        eval_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9 - held
        lc, later = r.loss_curve, r.epoch_times[1:]
        bar = ML20M_JAX_AUC[name] - ML20M_AUC_MARGIN
        readings[name] = dict(
            auc=auc, gauc=g, bar=bar, fit_s=fit_s, eval_s=eval_s,
            peak_gb=peak, epochs=len(lc),
            ex_per_s=sample.rows * len(later) / sum(later),
            step_ms=sum(later) / (steps * len(later)) * 1e3)
        rankers[name] = r
        log(f"[ml20m] {name}: fit {fit_s:.3f} s ({len(lc)} epochs of "
            f"{steps} steps; epochs 2-: {readings[name]['ex_per_s']:.1f} "
            f"ex/s, {readings[name]['step_ms']:.4f} ms a step), loss curve "
            f"{[round(x, 6) for x in lc]}; peak device memory {peak:.3f} GB "
            f"above the {held:.3f} GB held before; predict + metrics over "
            f"{x_test.shape[0]} test rows {eval_s:.3f} s; held-out AUC "
            f"{auc:.6f} GAUC {g:.6f} (bar {bar:.6f}: JAX's lowest of five "
            f"seeds on the CPU {ML20M_JAX_AUC[name]} − {ML20M_AUC_MARGIN})")
        require(all(np.isfinite(lc)) and lc[-1] < lc[0]
                and bool(torch.isfinite(scores).all()),
                f"ml20m {name}: loss curve {lc}, finite scores "
                f"{bool(torch.isfinite(scores).all())}")
        require(auc > bar, f"ml20m {name}: held-out AUC {auc:.6f} <= bar "
                           f"{bar:.6f}")
        if name == "din":
            launches = {f.__name__: f.launches for f in counted}
            shuffled = torch.from_numpy(
                np.random.default_rng(SEED).permutation(te_y)).to(dev)
            ctl_auc = float(roc_auc_device(scores, shuffled))
            require(ctl_auc <= bar, f"ml20m control: DIN against shuffled "
                                    f"labels reads AUC {ctl_auc:.6f} > {bar}")
        del scores
    require(all(launches.values()),
            f"ml20m DIN: a kernel of the path was never launched {launches}")
    log(f"[ml20m] DIN pallas launches: fit {fit_launches}, fit + predict "
        f"{launches}; control: DIN's scores against shuffled labels AUC "
        f"{ctl_auc:.6f} (bar {readings['din']['bar']:.6f})")

    # K2 and K2b on the DIN fit's first step, with phase 9's limits
    din = rankers["din"]
    cfg = script.trainer_config("din", args.epochs, args)
    step = dense_first_step(torch, din.model, sample, cfg, dev)
    errs, ctl = check_dense_kernels(torch, step, "ml20m-kernels")
    times = time_dense_kernels(torch, step, "ml20m-kernels")
    del step
    prof = profile_dense_steps(torch, din, sample, dataclasses.replace(
        cfg, epochs=1), dev)
    idle = max(0.0, 1 - prof["busy_ms"] / prof["wall_ms"])
    del rankers, din
    torch.cuda.empty_cache()
    log(f"[ml20m] done in {time.perf_counter() - t_phase:.1f} s: profiled "
        f"DIN step busy {prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} "
        f"(idle share {idle:.3f}); kernel controls {ctl}")
    entries = []
    for key, name, src, replaces, count in (
            ("K2", "din_attention (ml20m DIN)", "din_attention.cu",
             "goctr_tpu/ops/pallas/din_attention.py:97",
             "din_attention_pool"),
            ("K2b", "din_attention_bwd (ml20m DIN)", "din_attention_bwd.cu",
             "goctr_tpu/parallel/sparse_ctr.py:128",
             "din_attention_pool_bwd")):
        t = times[key]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"goctr_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[count],
            "max_abs_err": max(v for k, v in errs.items()
                               if k.split()[0] == key),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    out.update(models=readings, idle=idle, launches=launches,
               control_auc=ctl_auc, stats=stats)
    return entries, out


# ------------------------------------------------------------ phase 14 --
# the mesh on one card: ranks that share cuda:0 over gloo (core/meshes.py)
MESH_RANKS_STEPS = 3                # steps an epoch of (a) and (c)
MESH_RANKS_EPOCHS = 2
MESH_RANKS_GROUPED_STEPS = 3        # (b): one epoch
MESH_RANKS_DENSE_VOCAB = 1_000_000  # (c): its [V/m, 64] gradient crosses
#                                     the host every step
# loss curves of (d, m) vs the 1×1 run of the same start: an H100 at 700 W
# read 3.0e-6 for (a), 1.9e-6 for (c) and 0 for (b) (one data shard: the
# 1×1 stream), the control 1.5e-3
MESH_RANKS_LOSS_RTOL = 1e-4
MESH_RANKS_TIMEOUT_S = 600


class Capture:
    """Replaces a module's kernel wrapper with a pass-through that keeps a
    copy of its first call's arguments (the inputs the main path gave it
    on this rank)."""

    def __init__(self, torch, module, attr):
        self.torch, self.module, self.attr = torch, module, attr
        self.real = getattr(module, attr)
        self.args = None

    def __enter__(self):
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.real)

    def __call__(self, *args, **kw):
        if self.args is None:
            self.args = ([a.clone() if self.torch.is_tensor(a) else a
                          for a in args], dict(kw))
        return self.real(*args, **kw)


def mesh_ranks_configs():
    """(name, spec, model config, table_opt kwargs or None, rows an
    epoch, epochs): (a) the headline through train_sparse on 2×2 with the
    split update and with K5; (b) the 100M × 16 resident lines on 1×2
    with K6; (c) the dense path with mean pooling on 2×2 (adam on every
    leaf, the table shard included)."""
    steps = MESH_RANKS_STEPS * TRAIN_BATCH
    fused = dict(kind="adagrad", lr=TABLE_LR, update_mode="fused")
    return [
        ("a-split", (2, 2), HEADLINE, dict(fused, rmw_impl="split"), steps,
         MESH_RANKS_EPOCHS),
        ("a-kernel", (2, 2), HEADLINE, dict(fused, rmw_impl="kernel"),
         steps, MESH_RANKS_EPOCHS),
        ("c-dense", (2, 2), dict(HEADLINE, pooling="mean",
                                 item_vocab=MESH_RANKS_DENSE_VOCAB), None,
         steps, MESH_RANKS_EPOCHS),
        ("b-grouped", (1, 2), GROUPED, dict(fused, rmw_impl="kernel"),
         MESH_RANKS_GROUPED_STEPS * TRAIN_BATCH, 1)]


def mesh_ranks_run(torch, mesh, mc, topt, rows, epochs, dev):
    """train_sparse of one configuration on `mesh` (1×1 in the parent, a
    rank's shards in a rank), fresh from SEED; (loss curve, epoch
    seconds, bytes of the trained table on this rank)."""
    from goctr_tpu_torch.models.trainer import TrainerConfig
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR
    from goctr_tpu_torch.parallel.sparse_trainer import train_sparse
    from goctr_tpu_torch.parallel.table_opt import TableOptConfig

    sample = make_workload(rows, mc["item_vocab"], mc["behavior_len"],
                           mc["u_profile_dim"], mc["ctx_dim"], seed=SEED)[0]
    cfg = TrainerConfig(batch_size=TRAIN_BATCH, epochs=epochs, early_stop=0,
                        lr=1e-3, l2=0.0, shuffle=True, seed=SEED)
    r = train_sparse(
        SparseCTR(**mc, compute_dtype=torch.bfloat16, device=dev), sample,
        mesh, cfg, table_opt=TableOptConfig(**topt) if topt else None)
    require(r.lookup_overflow_max == 0 and all(np.isfinite(r.loss_curve)),
            "mesh ranks: overflow or a non-finite loss")
    return list(r.loss_curve), list(r.epoch_times), r.table.numel() * 4


def mesh_ranks_kernels(torch, name, caps):
    """Each captured kernel against its plain version on this rank's own
    inputs (K1 and K3 on the locally masked ids, K5 / K6 on the stage-4
    stream of this model shard; K3's control, its ids shifted by one row,
    must leave entries outside TOL); returns {kernel: max err}."""
    from goctr_tpu_torch.ops.kernels import embedding_lookup as k3
    from goctr_tpu_torch.ops.kernels import row_gather as k1
    from goctr_tpu_torch.ops.kernels import row_optimizer as ro

    out = {}
    for key, cap in caps.items():
        (args, kw) = cap.args
        if key == "K1":
            got = k1.gather_rows(*args, **kw)
            want = k1.gather_rows_plain(*args, **kw)
            require(torch.equal(torch.nan_to_num(got),
                                torch.nan_to_num(want)),
                    f"mesh ranks {name}: K1 differs from plain")
            err = 0.0
        elif key == "K3":
            want = k3.fused_gather_pool_plain(*args, **kw)
            err = max_err(torch, k3.fused_gather_pool(*args, **kw), want,
                          "float32", f"mesh ranks {name} K3 sum")
            # control: the shard's ids shifted by one row
            table, ids = args[:2]
            shifted = torch.where(ids >= 0, (ids + 1) % table.shape[0], ids)
            bad, _ = within(torch, k3.fused_gather_pool(table, shifted,
                                                        *args[2:], **kw),
                            want, TOL["float32"][1], TOL["float32"][0])
            require(bad > 0, f"mesh ranks {name}: K3 on shifted ids passes "
                             "the limit")
        else:
            kern, plain = ((ro.apply_row_updates, ro.apply_row_updates_plain)
                           if key == "K5" else
                           (ro.apply_line_updates,
                            ro.apply_line_updates_plain))
            table, ids, upd = args
            hit = ids[ids < kw["skip_ge"]].long()
            got = kern(table.clone(), ids, upd, **kw)[hit]
            want = plain(table.clone(), ids, upd, **kw)[hit]
            err = max_err(torch, got, want, "float32",
                          f"mesh ranks {name} {key}")
            require(hit.numel() > 0, f"mesh ranks {name}: {key} updated no "
                                     "line of this shard")
        out[key] = err
    return out


def mesh_ranks_times(torch, caps):
    """Each captured kernel, its plain version and its library call on
    this rank's inputs, by device time (torch.profiler, `device_ms`: no
    host gaps), with bounds; the kernel also by CUDA events around 20
    back-to-back calls of its wrapper (`event_ms`: the host's dispatch
    included where it outlasts the kernel). K3 also returns the share of
    its ids that are real (this shard's)."""
    import torch.nn.functional as F

    from goctr_tpu_torch.ops.kernels import embedding_lookup as k3
    from goctr_tpu_torch.ops.kernels import row_gather as k1
    from goctr_tpu_torch.ops.kernels import row_optimizer as ro

    def times(kernel, plain, library):
        out = dict(ms=device_ms(torch, lambda i: kernel(), 1),
                   event_ms=cuda_ms(torch, kernel),
                   plain_ms=device_ms(torch, lambda i: plain(), 1, iters=5),
                   library_ms=None)
        if library is not None:
            out["library_ms"] = device_ms(torch, lambda i: library(), 1)
        return out

    out = {}
    for key, cap in caps.items():
        args, kw = cap.args
        if key == "K1":
            table, ids = args
            d, g = kw["dim"], kw.get("group", 1)
            r = times(lambda: k1.gather_rows(*args, **kw),
                      lambda: k1.gather_rows_plain(*args, **kw),
                      lambda: torch.index_select(table, 0,
                                                 (ids // g).reshape(-1)))
            r.update(bytes=ids.numel() * (4 + d * 4) + row_sector_bytes(
                torch, ids, g, d, table.shape[1]), flops=0)
        elif key == "K3":
            table, ids = args[:2]
            b, k = ids.shape
            d = table.shape[1]
            valid = (ids >= 0).float()
            safe = ids.clamp_min(0)
            r = times(lambda: k3.fused_gather_pool(*args, **kw),
                      lambda: k3.fused_gather_pool_plain(*args, **kw),
                      lambda: F.embedding_bag(safe, table, mode="sum",
                                              per_sample_weights=valid))
            r.update(bytes=ids.numel() * 4 + b * d * 4 + torch.unique(
                         ids[ids >= 0]).numel() * d * 4,
                     flops=b * k * d, real_share=float(valid.mean()))
        else:
            kern, plain = ((ro.apply_row_updates, ro.apply_row_updates_plain)
                           if key == "K5" else
                           (ro.apply_line_updates,
                            ro.apply_line_updates_plain))
            table, ids, upd = args
            n_real = int((ids < kw["skip_ge"]).sum())
            live = (ro.group_size(kw["d"]) if key == "K6" else 1) * (
                kw["d"] + 1)
            r = times(lambda: kern(table, ids, upd, **kw),
                      lambda: plain(table, ids, upd, **kw), None)
            r.update(bytes=ids.numel() * 4 + n_real * (-(-4 * live // 32)
                                                       * 32) * 3,
                     flops=n_real * live * 8, slots=ids.numel(),
                     real=n_real)
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("flops"))
        out[key] = r
    return out


def mesh_rank_main(spec, names, device="cuda:0"):
    """One rank of phase 14: the configurations `names` on the (d, m) mesh
    of ranks that share cuda:0 (the `launch` target). Each configuration
    resets the launch counts just before and reads them just after; its
    kernels are captured on their first call, held against their plain
    versions on this rank's inputs and, one rank at a time, timed."""
    import torch

    from goctr_tpu_torch.core.meshes import (
        MeshSpec, barrier, make_mesh, single_device_mesh)
    from goctr_tpu_torch.parallel import embedding as emb
    from goctr_tpu_torch.parallel import train as tr

    torch.set_grad_enabled(False)
    dev = torch.device(device)
    n = spec[0] * spec[1]
    mesh = (make_mesh(MeshSpec(*spec), devices=[dev] * n) if n > 1
            else single_device_mesh(dev))
    configs = {c[0]: c for c in mesh_ranks_configs()}
    counted = counted_kernels()
    out = {"rank": mesh.rank, "coords": mesh.coords}
    for name in names:
        if name == "a-control":        # stage 4 writes each run one row on
            _, _, mc, topt, rows, _ = configs["a-split"]
            real = tr.apply_row_updates_split
            tr.apply_row_updates_split = (
                lambda table, ids, upd, skip_ge, real=real, **kw: real(
                    table, torch.where(ids < skip_ge, ids + 1, ids), upd,
                    skip_ge=skip_ge, **kw))
            try:
                out[name] = {"loss_curve": mesh_ranks_run(
                    torch, mesh, mc, topt, rows, 1, dev)[0]}
            finally:
                tr.apply_row_updates_split = real
            continue
        _, _, mc, topt, rows, epochs = configs[name]
        caps = {}
        with contextlib.ExitStack() as stack:
            if topt is None:
                caps["K3"] = stack.enter_context(
                    Capture(torch, emb, "fused_gather_pool"))
            else:
                caps["K1"] = stack.enter_context(
                    Capture(torch, emb, "gather_rows"))
                if topt.get("rmw_impl") == "kernel":
                    key, attr = (("K6", "apply_line_updates")
                                 if mc["emb_dim"] < 64 else
                                 ("K5", "apply_row_updates"))
                    caps[key] = stack.enter_context(
                        Capture(torch, tr, attr))
            for f in counted.values():
                f.launches = 0
            torch.cuda.reset_peak_memory_stats()
            curve, times, nbytes = mesh_ranks_run(torch, mesh, mc, topt,
                                                  rows, epochs, dev)
            torch.cuda.synchronize()
            launches = {k: f.launches for k, f in counted.items()}
            peak = torch.cuda.max_memory_allocated() / 1e9
        errs = mesh_ranks_kernels(torch, name, caps)
        timed = {}
        for r in range(mesh.size):           # one rank times at a time
            barrier(mesh)
            if r == mesh.rank:
                timed = mesh_ranks_times(torch, caps)
        barrier(mesh)
        out[name] = dict(loss_curve=curve, epoch_times=times,
                         launches=launches, peak_gb=peak, errs=errs,
                         times=timed, table_bytes=nbytes)
        del caps
        torch.cuda.empty_cache()
    return out


def nccl_roundtrip():
    """At world size 1 over NCCL on the card: all_reduce and all_gather
    return their input."""
    import torch
    import torch.distributed as dist

    x = torch.arange(12.0, device="cuda").reshape(4, 3)
    y = x.clone()
    dist.all_reduce(y)
    parts = [torch.empty_like(x)]
    dist.all_gather(parts, x)
    return (dist.get_backend(), bool(torch.equal(y, x)),
            bool(torch.equal(parts[0], x)))


def mesh_ranks_phase(torch, dev):
    """Phase 14: the (data, model) mesh on one card. The 1×1 references
    first (in this process, the same starts), the cache freed, then the
    ranks: 4 that share cuda:0 over gloo for (a) split, (a) K5, the
    control and (c), 2 for (b). Each loss curve is held to its 1×1 run
    within MESH_RANKS_LOSS_RTOL and the control must exceed it; NCCL round
    trip at world size 1; each rank's kernels vs plain, times, launches
    and peak memory. Returns the kernels-line entries (one a kernel and
    rank) and {"K5" / "K6": [(mesh and rank, readings)]}."""
    from goctr_tpu_torch.core.meshes import launch, single_device_mesh

    from goctr_tpu_torch.core.prng import randn_rows

    t_phase = time.perf_counter()
    # a shard's rows of a draw, drawn alone, are the whole draw's: across
    # the halves a draw past 2^31 bytes is cut into, and at (b)'s lines
    for shape, (a, b) in (((4_500_000, 128), (2_200_000, 2_300_000)),
                          ((14_285_715, 128), (7_142_858, 14_285_715))):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        whole = torch.randn(shape, generator=gen, device=dev)
        end = gen.get_offset()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        require(torch.equal(randn_rows(gen, shape, a, b), whole[a:b])
                and gen.get_offset() == end,
                f"randn_rows {shape} rows [{a}, {b}) differ from the whole "
                "draw")
        del whole
    torch.cuda.empty_cache()
    log("[mesh-ranks] randn_rows: rows of a CUDA draw drawn alone equal "
        "the whole draw's (4.5M x 128, 14.3M x 128)")
    configs = mesh_ranks_configs()
    one = single_device_mesh(dev)
    ref = {}
    for name, _, mc, topt, rows, epochs in configs:
        t0 = time.perf_counter()
        ref[name] = mesh_ranks_run(torch, one, mc, topt, rows, epochs, dev)
        log(f"[mesh-ranks] 1x1 reference {name}: loss curve {ref[name][0]} "
            f"({time.perf_counter() - t0:.1f} s)")
        torch.cuda.empty_cache()
    backend, *ok = launch(nccl_roundtrip, 1, [dev], "nccl",
                          timeout=MESH_RANKS_TIMEOUT_S)[0]
    require(backend == "nccl" and all(ok),
            f"mesh ranks: NCCL round trip failed {backend} {ok}")
    log("[mesh-ranks] NCCL at world size 1: all_reduce and all_gather "
        "round-trip on the card")
    if torch.cuda.device_count() >= 2:
        n = 4 if torch.cuda.device_count() >= 4 else 2
        spec = (2, 2) if n == 4 else (1, 2)
        devs = [torch.device("cuda", i) for i in range(n)]
        want = ref["a-split"][0]
        for r, got in enumerate(launch(mesh_rank_nccl, n, devs, "nccl",
                                       args=(spec,),
                                       timeout=MESH_RANKS_TIMEOUT_S)):
            require(len(got) == len(want),
                    f"mesh ranks (a) over NCCL rank {r}: {len(got)} epochs, "
                    f"1x1 {len(want)}")
            rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            require(rel <= MESH_RANKS_LOSS_RTOL,
                    f"mesh ranks (a) over NCCL rank {r}: loss curve {got} vs "
                    f"1x1 {want} (rel {rel:.3g} > {MESH_RANKS_LOSS_RTOL})")
            log(f"[mesh-ranks] (a) split over NCCL on {n} cards {spec} rank "
                f"{r}: loss curve {got} (rel diff {rel:.3g} vs 1x1)")
    else:
        log("[mesh-ranks] (a) over NCCL with one rank a card: not run, this "
            "machine has one card (NCCL refuses two ranks on one device)")
    t0 = time.perf_counter()
    ranks4 = launch(mesh_rank_main, 4, [dev] * 4, "gloo",
                    args=((2, 2), ["a-split", "a-kernel", "a-control",
                                   "c-dense"], str(dev)),
                    timeout=MESH_RANKS_TIMEOUT_S)
    t4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks2 = launch(mesh_rank_main, 2, [dev] * 2, "gloo",
                    args=((1, 2), ["b-grouped"], str(dev)),
                    timeout=MESH_RANKS_TIMEOUT_S)
    t2 = time.perf_counter() - t0
    rels = {}
    for name, spec, mc, _, rows, _ in configs:
        ranks = ranks2 if name == "b-grouped" else ranks4
        want = ref[name][0]
        for r in ranks:
            got = r[name]["loss_curve"]
            rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            rels[name] = max(rels.get(name, 0.0), rel)
            require(rel <= MESH_RANKS_LOSS_RTOL,
                    f"mesh ranks {name} rank {r['rank']}: loss curve {got} "
                    f"vs 1x1 {want} (rel {rel:.3g} > {MESH_RANKS_LOSS_RTOL})")
            path = {"a-split": ("gather_rows", "din_attention_pool",
                                "din_attention_pool_bwd",
                                "scatter_rows_packed"),
                    "a-kernel": ("gather_rows", "apply_row_updates"),
                    "b-grouped": ("gather_rows", "din_attention_pool",
                                  "apply_line_updates"),
                    "c-dense": ("fused_gather_pool", "gather_rows")}[name]
            la = r[name]["launches"]
            require(all(la[k] > 0 for k in path),
                    f"mesh ranks {name} rank {r['rank']}: a kernel of the "
                    f"path was never launched {la}")
            log(f"[mesh-ranks] {name} {spec} rank {r['rank']} {r['coords']}:"
                f" loss curve {got} (rel diff {rel:.3g} vs 1x1), epoch s "
                f"{r[name]['epoch_times']}, peak {r[name]['peak_gb']:.2f} "
                f"GB, table {r[name]['table_bytes'] / 1e9:.3f} GB "
                f"(1x1 {ref[name][2] / 1e9:.3f} GB), kernels vs plain "
                f"{r[name]['errs']}, launches "
                f"{ {k: v for k, v in la.items() if v} }")
        ex = rows * len(want) / sum(ranks[0][name]["epoch_times"])
        log(f"[mesh-ranks] {name}: {ex:.1f} examples/s over {len(ranks)} "
            f"ranks sharing one card (host-staged gloo collectives: not a "
            f"scaling number), 1x1 {rows * len(want) / sum(ref[name][1]):.1f}")
    ctl = max(abs(r["a-control"]["loss_curve"][0] - ref["a-split"][0][0])
              / abs(ref["a-split"][0][0]) for r in ranks4)
    require(ctl > MESH_RANKS_LOSS_RTOL,
            f"mesh ranks control: loss rel diff {ctl:.3g} is inside the "
            f"limit {MESH_RANKS_LOSS_RTOL}")
    log(f"[mesh-ranks] done in {time.perf_counter() - t_phase:.1f} s (4 "
        f"ranks {t4:.1f} s, 2 ranks {t2:.1f} s): loss rel diff vs 1x1 "
        f"{rels} (limit {MESH_RANKS_LOSS_RTOL}); control (stage 4 writing "
        f"each run one row on): rel diff {ctl:.3g}")
    entries, rmw = [], {"K5": [], "K6": []}
    for name, key, kname, src, replaces in (
            ("a-split", "K1", "row_gather", "row_gather.cu",
             "goctr_tpu/ops/pallas/row_gather.py:74"),
            ("c-dense", "K3", "gather_pool (sum)", "gather_pool.cu",
             "goctr_tpu/ops/pallas/embedding_lookup.py:106"),
            ("a-kernel", "K5", "row_rmw", "row_rmw.cu",
             "goctr_tpu/ops/pallas/row_optimizer.py:176"),
            ("b-grouped", "K6", "line_rmw", "row_rmw.cu",
             "goctr_tpu/ops/pallas/row_optimizer.py:699")):
        fn = {"K1": "gather_rows", "K3": "fused_gather_pool",
              "K5": "apply_row_updates", "K6": "apply_line_updates"}[key]
        spec = dict((c[0], c[1]) for c in configs)[name]
        for r in (ranks2 if name == "b-grouped" else ranks4):
            t = r[name]["times"][key]
            entries.append({
                "name": f"{kname} (mesh {spec[0]}x{spec[1]} rank "
                        f"{r['rank']})", "route": "cuda",
                "source": f"goctr_tpu_torch/csrc/{src}",
                "replaces": replaces,
                "launches": r[name]["launches"][fn],
                "max_abs_err": r[name]["errs"][key], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
            real = (f", {100 * t['real_share']:.1f}% of its ids real"
                    if key == "K3" else "")
            lib = ("none" if t["library_ms"] is None
                   else f"{t['library_ms']:.5f}")
            log(f"[mesh-ranks] {key} {name} rank {r['rank']} device ms per "
                f"call (profiler): kernel {t['ms']:.5f}, plain "
                f"{t['plain_ms']:.5f}, library {lib}, bound "
                f"{t['bound_ms']:.5f} ({t['bound_by']}, "
                f"{100 * t['bound_ms'] / t['ms']:.1f}% of it){real}; CUDA "
                f"events over 20 back-to-back wrapper calls: "
                f"{t['event_ms']:.5f} ms a call")
            if key in rmw:
                rmw[key].append((f"mesh {spec[0]}x{spec[1]} rank "
                                 f"{r['rank']}", t))
    return entries, rmw


def rmw_share_lines(headline, mesh):
    """One line a kernel (K5, K6): its real-slot share, device ms per
    call, bound and share of the bound on the scanned trainer's first
    step (phases 6 and 7) and on each mesh rank's stage-4 stream (phase
    14), all of this run."""
    for key, head in headline.items():
        log(f"[rmw-share] {key}: " + "; ".join(
            f"{label} {t['real']} real of {t['slots']} slots "
            f"({100 * t['real'] / t['slots']:.1f}%), {t['ms']:.5f} ms, "
            f"bound {t['bound_ms']:.5f}, {100 * t['bound_ms'] / t['ms']:.1f}% "
            f"of the bound"
            for label, t in [("scanned trainer", head), *mesh[key]]))


# ----------------------------------------------------------- phase 15a --
# DLRM-DCNv2 (parallel/dlrm.py) at MLPerf's widths and bags, each table cut
# to at most DLRM_ROWS rows: the 1-of-8 share that the benchmark's
# configuration dlrm_dcnv2_criteo1tb_1of8 trains (V 29,184,588), its ids
# drawn by the cell's law (bounded zipf DLRM_ZIPF_S over each feature's
# rows, the ranks hashed across them by DLRM_PRIME), DLRM_STEPS steps of
# TRAIN_BATCH at the configuration's learning rates
DLRM_ROWS = 5_000_000
DLRM_STEPS = 4
DLRM_ZIPF_S = 1.05
DLRM_PRIME = 2_654_435_761
DLRM_LR = 0.002
DLRM_TABLE_LR = 0.005


def dlrm_kwargs():
    from goctr_tpu_torch.parallel.dlrm import MLPERF_ROWS

    return {"rows": tuple(min(r, DLRM_ROWS) for r in MLPERF_ROWS),
            "init_rows": MLPERF_ROWS}


def dlrm_sample(model, n, seed):
    """n rows of a DLRMSample: feature f's ids bounded-zipf ranks over its
    rows, rank r at row r · DLRM_PRIME mod rows; dense features log(1 + c)
    of lognormal counts; labels 1 for about 0.3 of the rows."""
    from goctr_tpu_torch.parallel.dlrm import DLRMSample

    rng = np.random.default_rng(seed)
    ids = np.concatenate([
        (_zipf_ranks(rng, (n, h), r, DLRM_ZIPF_S) * DLRM_PRIME % r)
        .astype(np.int32) for h, r in zip(model.hotness, model.rows)], 1)
    counts = np.floor(np.exp(rng.normal(1.0, 1.5, (n, model.dense_dim))))
    return DLRMSample(np.log1p(counts).astype(np.float32), ids,
                      (rng.random(n) < 0.3).astype(np.float32))


def dlrm_phase(torch, dev):
    """Phase 15a: DLRM-DCNv2's main path and the two kernels it brought.
    The main path: `train_sparse_scanned` over DLRM_STEPS batches, fused
    at D = 128 (K3's bags, the "xla" compaction, the split update's K1
    read and K4 write), launch counts reset just before and read just
    after: one launch of each a step and no other kernel. Then, on the
    trained table and the first batch's ids: K3 with column offsets
    against its plain version (a control: the offsets shifted by one
    column), timed beside embedding_bag over the same bags; the "xla"
    compaction's unpacked [capr, 128] run sums of a step's bf16 stream
    against its plain version (a control: two runs swapped), timed.
    Returns the two `kernels` line entries, their launches the main
    path's."""
    from goctr_tpu_torch.models.trainer import TrainerConfig
    from goctr_tpu_torch.ops.kernels import compact_xla as kx
    from goctr_tpu_torch.ops.kernels import embedding_lookup as k3
    from goctr_tpu_torch.parallel.dlrm import DLRMDCNv2
    from goctr_tpu_torch.parallel.scanned import (
        TableOptConfig, train_sparse_scanned)

    t0 = time.perf_counter()
    model = DLRMDCNv2(**dlrm_kwargs(), compute_dtype=torch.bfloat16,
                      device=dev)
    b, k, d = TRAIN_BATCH, model.ids_per_example, model.emb_dim
    v, f = model.item_vocab, model.n_features
    sample = dlrm_sample(model, DLRM_STEPS * b, SEED + 15)
    gids = torch.from_numpy(sample.ids[:b]).to(dev) + model.col_base
    flat = gids.reshape(-1).long()
    distinct = torch.unique(flat).numel()
    capr = -(-int(distinct * 1.15) // 1024) * 1024
    cfg = TrainerConfig(batch_size=b, epochs=1, seed=SEED, solver="adagrad",
                        lr=DLRM_LR, l2=0.0, early_stop=0, shuffle=False)
    topt = TableOptConfig(kind="adagrad", lr=DLRM_TABLE_LR,
                          update_mode="fused", rmw_impl="split",
                          compact_impl="xla", compact_cap=capr)

    # the main path: counts reset just before, read just after
    path = ("fused_gather_pool", "compact_xla_rows", "gather_rows",
            "scatter_rows_packed")
    counted = counted_kernels()
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    result = train_sparse_scanned(model, sample, cfg, topt, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    launches = {name: fn.launches for name, fn in counted.items()
                if fn.launches or name in path}
    require(all(launches.get(name) == DLRM_STEPS for name in path)
            and set(launches) == set(path),
            f"[dlrm] main path launches {launches}: one of each of "
            f"{path} a step wanted, {DLRM_STEPS} steps")
    losses = result.loss_curve
    require(len(losses) == 1 and np.isfinite(losses).all()
            and result.update_overflow_max == 0
            and tuple(result.table.shape) == (v, d),
            f"[dlrm] loss {losses}, overflow {result.update_overflow_max}, "
            f"table {tuple(result.table.shape)}")
    log(f"[dlrm] train_sparse_scanned V={v} (tables <= {DLRM_ROWS} rows) "
        f"D={d}, {DLRM_STEPS} steps of {b} (fused split, xla compaction, "
        f"capr {capr}): loss {losses[0]:.6f}, {train_s:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches "
        f"{launches}")
    table = result.table
    del result

    off = model.col_offsets
    got = k3.fused_gather_pool(table, gids, "sum", off)
    want = k3.fused_gather_pool_plain(table, gids, "sum", off)
    k3_err = max_err(torch, got, want, "float32", "K3 DLRM bags")
    shifted = off.clone()
    shifted[1:-1] += 1
    bad, _ = within(torch, k3.fused_gather_pool(table, gids, "sum", shifted),
                    want, TOL["float32"][1], TOL["float32"][0])
    require(bad > 0, "K3 DLRM bags: shifted offsets pass the tolerance")
    del got, want
    bag_starts = torch.arange(b, device=dev)[:, None] * k + off[:-1]
    k3_bytes = distinct * d * 4 + flat.numel() * 4 + b * f * d * 4
    k3_ms = device_ms(torch, lambda i: k3.fused_gather_pool(
        table, gids, "sum", off), 1)
    k3_plain_ms = device_ms(torch, lambda i: k3.fused_gather_pool_plain(
        table, gids, "sum", off), 1, iters=3)
    k3_lib_ms = device_ms(torch, lambda i: torch.nn.functional.embedding_bag(
        flat, table, bag_starts.reshape(-1), mode="sum"), 1)
    k3_bound_ms, k3_by = bound(k3_bytes, flat.numel() * d)
    log(f"[dlrm] K3 B={b} F={f} K={k} D={d} V={v} ({distinct} distinct "
        f"rows, {distinct / flat.numel():.4f} of the ids): max_abs_err "
        f"{k3_err:.3g}; device ms kernel {k3_ms:.5f}, plain "
        f"{k3_plain_ms:.5f}, embedding_bag {k3_lib_ms:.5f}, bound "
        f"{k3_bound_ms:.5f} ({k3_bytes} B, {k3_by})")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    g = torch.randn(flat.numel(), d, generator=gen, device=dev).to(
        torch.bfloat16)
    ids_flat = gids.reshape(-1)
    s_ids, order = kx.sort_ids(ids_flat, v)
    tgt, rows, over = kx.compact_xla_rows(ids_flat, s_ids, order, g, v,
                                          capr, False)
    w_tgt, w_rows, w_over = kx.compact_xla_rows_plain(
        ids_flat, s_ids, order, g, v, capr, False)
    require(torch.equal(tgt, w_tgt) and int(over) == int(w_over) == 0,
            "compact_xla D=128: targets or overflow differ")
    bits = lambda x: x.contiguous().view(torch.int32)
    require(torch.equal(bits(rows), bits(w_rows)),
            "compact_xla D=128: run sums differ from the plain version")
    moved = rows.clone()
    moved[[0, 1]] = moved[[1, 0]]
    require(not torch.equal(bits(moved), bits(w_rows)),
            "compact_xla D=128: a moved run passes")
    del w_rows, moved
    n_real = int((tgt < v).sum())
    cx_bytes = g.numel() * 2 + ids_flat.numel() * 16 + capr * (d * 4 + 4)
    cx_ms = device_ms(torch, lambda i: kx.compact_xla_rows(
        ids_flat, s_ids, order, g, v, capr, False), 1)
    cx_plain_ms = device_ms(torch, lambda i: kx.compact_xla_rows_plain(
        ids_flat, s_ids, order, g, v, capr, False), 1, iters=3)
    cx_bound_ms, cx_by = bound(cx_bytes, g.numel())
    log(f"[dlrm] compact_xla D=128 unpacked, bf16 rows n={ids_flat.numel()}"
        f", capr {capr}, {n_real} runs: bit for bit vs plain; device ms "
        f"kernel {cx_ms:.5f}, plain {cx_plain_ms:.5f}, bound "
        f"{cx_bound_ms:.5f} ({cx_bytes} B); phase "
        f"{time.perf_counter() - t0:.1f} s")
    del table, g, rows, tgt
    torch.cuda.empty_cache()
    return [{"name": "gather_pool (DLRM bags, column offsets)",
             "route": "cuda", "source": "goctr_tpu_torch/csrc/gather_pool.cu",
             "replaces": "goctr_tpu/ops/pallas/embedding_lookup.py:106",
             "launches": launches["fused_gather_pool"],
             "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms,
             "bound_ms": k3_bound_ms, "bound_by": k3_by,
             "library_ms": k3_lib_ms},
            {"name": "compact_xla (D = 128 unpacked)", "route": "cuda",
             "source": "goctr_tpu_torch/csrc/compact_xla.cu",
             "replaces": "goctr_tpu/parallel/scanned.py:296-311",
             "launches": launches["compact_xla_rows"], "max_abs_err": 0.0,
             "ms": cx_ms, "plain_ms": cx_plain_ms, "bound_ms": cx_bound_ms,
             "bound_by": cx_by, "library_ms": None}]


# ------------------------------------------------------------ phase 15 --
def sync_phase(torch, dev):
    """Phase 15: one step of each training path that promises not to make
    the host wait on the card (goctr_tpu_torch/parallel/step_cases.py:
    the scanned trainer in every update mode and its kernel variants, the
    1×1 mesh's sparse step in fused (K5), dedup, sorted and plain, its
    dense step (K3), the dense rankers' steps (MLPTower, YoutubeDNN, DIN
    "xla" and "pallas": K2, K2b), the capped lookup's _dedup_flat and
    DLRM-DCNv2's scanned step (K3 bags, D = 128 fused split) at
    the headline widths (the grouped cases at GROUPED's, the rankers at
    ML20M's) and batch, each called once to build and warm up and once
    under torch.cuda.set_sync_debug_mode("error"), where any wait raises;
    no failure is caught. Prints one line naming every case that
    passed."""
    from goctr_tpu_torch.parallel.step_cases import step_cases

    t0 = time.perf_counter()
    passed = []
    for name, build in step_cases(dev, HEADLINE, GROUPED, ML20M,
                                  TRAIN_BATCH, dlrm=dlrm_kwargs()):
        step = build()
        step()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        passed.append(name)
        del step
        torch.cuda.empty_cache()
    log(f"[sync] no wait under set_sync_debug_mode(\"error\") in "
        f"{len(passed)} steps at batch {TRAIN_BATCH} "
        f"({time.perf_counter() - t0:.1f} s): {', '.join(passed)}")


def mesh_rank_nccl(spec):
    """(a) split's loss curve on one rank a card over NCCL."""
    import torch

    from goctr_tpu_torch.core.meshes import MeshSpec, make_mesh

    torch.set_grad_enabled(False)
    n = spec[0] * spec[1]
    mesh = make_mesh(MeshSpec(*spec),
                     devices=[torch.device("cuda", i) for i in range(n)])
    _, _, mc, topt, rows, epochs = mesh_ranks_configs()[0]
    return mesh_ranks_run(torch, mesh, mc, topt, rows, epochs,
                          mesh.device)[0]


# ------------------------------------------------------------ phase 16 --
# the headline and BASELINE #5 at the JAX bench's own depth: bench.py's
# defaults (:130-150) and its 100M x 16 command (BENCH_NOTES.md:95-100),
# as goctr_tpu_torch.bench's flags; each on its own draw of rows +
# 250,000 held-out rows (bench.py:139-174)
DEPTH = {"headline": [],
         "baseline5": ["--vocab=100000000", "--dim=16", "--rows=1000000",
                       "--batch=16384", "--epochs=3"]}
# the bars: the JAX package's held-out readings of the same draws less
# 0.01 — the headline's eval_auc 0.8442 and eval_gauc 0.8443
# (BENCH_r05.json), BASELINE #5's eval_auc 0.7925, the lower of its two
# readings (BENCH_NOTES.md:97-100; 0.800 at :245-246). JAX's own headline
# readings across batch sizes and update routes spread by 0.0016
# (BENCH_NOTES.md:41-45, 272-277)
DEPTH_BARS = {"headline": {"eval_auc": 0.8342, "eval_gauc": 0.8343},
              "baseline5": {"eval_auc": 0.7825}}
# the oracle's AUC on each draw as bench.py reported it, and its digits:
# the draw is bench.py's
DEPTH_CEILING = {"headline": (0.8734, 4), "baseline5": (0.872, 3)}
# the trained scores against a fixed permutation of the held-out labels
# (goctr_tpu_torch.bench.evaluate's control_auc) must read chance within
# this (the null AUC's sd at 250,000 rows is ~0.0012)
DEPTH_CONTROL_ATOL = 0.02
# the training path's kernels: launched in every depth run, or never
DEPTH_LAUNCHED = ("gather_rows", "din_attention_pool",
                  "din_attention_pool_bwd", "scatter_rows_packed",
                  "compact_xla_rows")
DEPTH_IDLE = ("compact_runsums_block", "apply_row_updates",
              "apply_line_updates", "apply_csum_updates",
              "apply_run_updates", "fused_gather_pool")
# bench.py's JSON keys in its order (:288-303), with held-out metrics on
# the noisy draw and both serving rates
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline",
              "model_flops_per_example", "mfu_pct",
              "model_bytes_per_example", "hbm_util_pct", "workload",
              "eval_auc", "eval_gauc", "eval_auc_ceiling",
              "serving_scores_per_s", "serving_device_scores_per_s"]


def depth_run(torch, dev, s, draw, seed=SEED):
    """goctr_tpu_torch.bench's training run of settings `s` on `draw`
    (bench.train, trainer seed `seed`), launch counts reset just before
    and read just after, then its held-out readings (bench.evaluate: the
    device metrics, their distance from numpy, which must be within
    METRIC_ATOL, and the permuted-label control) and the run's own
    (Run.readings). Returns (the run, the readings)."""
    counted = counted_kernels()
    for f in counted.values():
        f.launches = 0
    run = bench.train(s, draw, dev, seed)
    launches = {k: f.launches for k, f in counted.items()}
    ev = bench.evaluate(run, dev)
    require(all(np.isfinite(ev[k]) for k in ("eval_auc", "eval_gauc")),
            f"eval metrics not finite: {ev}")
    require(ev["metric_err"] <= METRIC_ATOL,
            f"device metrics vs numpy differ by {ev['metric_err']}")
    ev.update(run.readings(), launches=launches)
    return run, ev


def check_depth(name, ev):
    """Phase 16's bars on one run's readings (module constants)."""
    for key, bar in DEPTH_BARS[name].items():
        require(ev[key] >= bar, f"depth {name}: {key} {ev[key]:.6f} below "
                                f"the bar {bar}")
    want, digits = DEPTH_CEILING[name]
    require(round(ev["eval_auc_ceiling"], digits) == want,
            f"depth {name}: ceiling {ev['eval_auc_ceiling']:.6f} does not "
            f"round to bench.py's {want}: not bench.py's draw")
    require(abs(ev["control_auc"] - 0.5) <= DEPTH_CONTROL_ATOL,
            f"depth {name}: permuted-label AUC {ev['control_auc']:.6f} not "
            f"within {DEPTH_CONTROL_ATOL} of 0.5")
    lc = ev["loss_curve"]
    require(all(np.isfinite(lc)), f"depth {name}: loss {lc}")
    launched = ev["launches"]
    require(all(launched[k] > 0 for k in DEPTH_LAUNCHED)
            and not any(launched[k] for k in DEPTH_IDLE),
            f"depth {name}: launches {launched}")


def bench_check(torch, dev, run, ev):
    """The [bench] line: goctr_tpu_torch.bench's JSON line of the trained
    headline (its serving rates measured here), held to bench.py's keys,
    finite values, MFU and HBM use in (0, 100] of the card's peaks and
    serving rates above 0; one DeviceScorer batch of its serving requests
    within SCORE_ATOL_TRAINED of predict on the same rows, and the same
    scores against predict of the candidates one place on (control).
    Returns the line."""
    from goctr_tpu_torch.parallel.sparse_trainer import SparseSample
    from goctr_tpu_torch.serve.scorer import DeviceScorer

    rates = bench.serve_rates(run, dev)
    line = bench.bench_line(run, ev, rates, bench.card_peaks(
        torch.cuda.get_device_name(dev)))
    log(f"[bench] {json.dumps(line)}")
    require(list(line) == BENCH_KEYS, f"[bench] keys {list(line)}")
    nums = {k: v for k, v in line.items() if not isinstance(v, str)}
    require(all(np.isfinite(v) for v in nums.values()),
            f"[bench] values not finite: {nums}")
    require(0 < line["mfu_pct"] <= 100 and 0 < line["hbm_util_pct"] <= 100,
            f"[bench] mfu_pct {line['mfu_pct']}, hbm_util_pct "
            f"{line['hbm_util_pct']}")
    require(line["serving_scores_per_s"] > 0
            and line["serving_device_scores_per_s"] > 0,
            f"[bench] serving rates {rates}")
    ev_rows = run.draw.eval_sample
    got = np.concatenate(bench.serving_batch(
        DeviceScorer.from_scanned(run.ranker, device=dev), ev_rows, 0))

    def predicted(shift):
        reqs = [bench.serving_request(ev_rows, r)
                for r in range(bench.SERVE_R)]
        k = [np.roll(c, shift) for _, _, _, c in reqs]
        rep = np.repeat(np.arange(len(reqs)), [len(c) for c in k])
        rows = SparseSample(
            np.stack([p for p, _, _, _ in reqs])[rep],
            np.stack([b for _, b, _, _ in reqs])[rep], np.concatenate(k),
            np.stack([c for _, _, c, _ in reqs])[rep],
            np.zeros(len(rep), np.float32))
        return run.ranker.predict(rows)

    err = float(np.abs(got - predicted(0)).max())
    ctl = float(np.abs(got - predicted(1)).max())
    require(err <= SCORE_ATOL_TRAINED,
            f"[bench] DeviceScorer vs predict: {err:.3g} > "
            f"{SCORE_ATOL_TRAINED}")
    require(ctl > SCORE_ATOL_TRAINED,
            f"[bench] control (candidates one place on) reads {ctl:.3g}")
    log(f"[bench] one DeviceScorer batch ({bench.SERVE_R} requests x "
        f"{bench.SERVE_K}) vs predict on the same rows: max err {err:.3g} "
        f"(limit {SCORE_ATOL_TRAINED}; candidates one place on read "
        f"{ctl:.3g})")
    return line


def depth_phase(torch, dev):
    """Phase 16: each DEPTH configuration drawn (its Settings' draw, made
    anew and dropped after its run: 5.25M rows are ~2 GB of host memory),
    trained (depth_run) and held to its bars (check_depth); the headline's
    run also gives the [bench] line (bench_check). No failure is caught,
    and an overflowing compact_cap is logged beside the bars. Returns the
    readings by name and the bench line."""
    t_phase = time.perf_counter()
    make_workload.cache_clear()         # the earlier phases' draws
    out = {}
    for name, flags in DEPTH.items():
        t0 = time.perf_counter()
        s = bench.settings(flags)
        draw = s.draw()
        t_draw = time.perf_counter() - t0
        run, ev = depth_run(torch, dev, s, draw)
        log(f"[depth] {name}: V={s.vocab} D={s.dim} (G="
            f"{ev['table_group']}), {s.rows} rows + {s.eval_rows} "
            f"held out drawn in {t_draw:.1f} s, batch {s.batch}, "
            f"{ev['steps_per_epoch']} steps an epoch (the last with "
            f"{ev['pad_rows']} padded rows), compact_cap "
            f"{ev['compact_cap']}: loss curve {ev['loss_curve']}, epoch s "
            f"{ev['epoch_s']}, steady {ev['steady_ex_per_s']:.1f} ex/s, "
            f"step {ev['step_ms']:.3f} ms, peak device memory "
            f"{ev['peak_gb']:.2f} GB, overflow {ev['overflow']}; launches "
            f"{ev['launches']}")
        log(f"[depth] {name}: held-out eval_auc {ev['eval_auc']:.6f} "
            f"eval_gauc {ev['eval_gauc']:.6f} eval_auc_ceiling "
            f"{ev['eval_auc_ceiling']:.6f} (bars {DEPTH_BARS[name]}); "
            f"device vs numpy {ev['metric_err']:.3g} (limit {METRIC_ATOL}); "
            f"permuted labels {ev['control_auc']:.6f}; run "
            f"{time.perf_counter() - t0:.1f} s")
        check_depth(name, ev)
        if name == "headline":
            line = bench_check(torch, dev, run, ev)
        out[name] = ev
        del run, draw
        torch.cuda.empty_cache()
    log(f"[depth] done in {time.perf_counter() - t_phase:.1f} s")
    return out, line


# ------------------------------------------------------------ phase 17 --
# goctr_tpu_torch.bench_kernels at the JAX script's default shapes (no
# shape is cut; each subcommand's reps are the JAX script's): every
# subcommand once, then the stage table's candidates (--parts)
BENCH_KERNELS_ARGV = (["din", "gather", "scatter", "fused", "segsum",
                       "stages", "rowgather"], ["stages", "--parts"])
# the wrappers its kernel rows launch (K1 also as the split update's
# read, K4 as its write)
BENCH_KERNELS_LAUNCHED = ("gather_rows", "din_attention_pool",
                          "fused_gather_pool", "apply_row_updates",
                          "scatter_rows_packed")


def bench_kernels_phase(torch, dev):
    """Phase 17: goctr_tpu_torch.bench_kernels (`main`, as
    `python3 -m goctr_tpu_torch.bench_kernels` runs it) over
    BENCH_KERNELS_ARGV at the JAX script's default shapes; it holds each
    kernel row against its plain row and returns nonzero on a failed row.
    Launch counts reset just before and read just after: each wrapper of
    BENCH_KERNELS_LAUNCHED launched. Then goctr_tpu_torch.profile_assembly
    on phase 13's fixture (the port's ML-20M-statistics generator at
    ML20M_SCALE with ML20M_KNOBS, made again), its item2vec trained on the
    card, over phase 13's training rows: the JAX script's stage lines and
    its rows / width / total line (`[assembly]`); the matrix finite, of
    the protocol's width, its behavior embeddings nonzero. Returns the
    readings."""
    import tempfile

    from goctr_tpu_torch.data.ml20m import SignalKnobs, generate_ml20m_fixture

    t_phase = time.perf_counter()
    counted = counted_kernels()
    for f in counted.values():
        f.launches = 0
    for argv in BENCH_KERNELS_ARGV:
        log(f"[bench-kernels] python3 -m goctr_tpu_torch.bench_kernels "
            f"{' '.join(argv)}")
        rc = bench_kernels.main(argv)
        require(rc == 0, f"bench_kernels {argv}: exit code {rc}")
    launches = {name: f.launches for name, f in counted.items()}
    require(all(launches[k] for k in BENCH_KERNELS_LAUNCHED),
            f"bench_kernels: a kernel row launched no kernel {launches}")
    t_bench = time.perf_counter() - t_phase
    log(f"[bench-kernels] done in {t_bench:.1f} s; launches {launches}")

    args = parity_script().parse_args([f"--scale={ML20M_SCALE}"]
                                      + ML20M_FLAGS)
    with tempfile.TemporaryDirectory() as tmp:
        db = f"{tmp}/ml20m.db"
        t0 = time.perf_counter()
        generate_ml20m_fixture(db, scale=ML20M_SCALE,
                               knobs=SignalKnobs(**ML20M_KNOBS),
                               oversample=args.oversample)
        t_gen = time.perf_counter() - t0
        log(f"[assembly] python3 -m goctr_tpu_torch.profile_assembly "
            f"--db=<scale {ML20M_SCALE} fixture, made in {t_gen:.1f} s> "
            f"--cnt={args.sample_cnt}")
        x, stages = profile_assembly.profile(
            db, args.sample_cnt, device=dev,
            say=lambda m: log(f"[assembly] {m}"))
    line = profile_assembly.summary(x, stages)
    log(f"[assembly] {line}")
    info = ml20m_info()
    beh = x[:, slice(*info.user_behavior_range)]
    require(0 < x.shape[0] <= args.sample_cnt and x.shape[1] == info.width
            and bool(np.isfinite(x).all()) and bool(np.abs(beh).sum() > 0),
            f"assembly: matrix {x.shape}, finite {np.isfinite(x).all()}")
    log(f"[bench-kernels] phase done in {time.perf_counter() - t_phase:.1f} "
        f"s")
    return {"bench_s": t_bench, "stages": stages, "rows": x.shape[0],
            "rows_per_s": x.shape[0] / max(sum(stages.values()), 1e-9)}


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
    for name in libs:                   # ptxas: registers, smem, spills
        for line in _build.resources(name):
            log(f"[build] {name}: {line}")

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
    din_bytes, din_flops, _, _ = pool_bounds(B, T, D)
    din_bound_ms, din_bound_by = bound(din_bytes, din_flops)
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
    torch.cuda.empty_cache()

    # 9. the dense rankers --------------------------------------------------
    dense_entries, _ = dense_phase(torch, dev)

    # 10. item2vec; 11. the sklearn-style MLPs (no kernel on their path) ----
    w2v = item2vec_phase(torch, dev)
    mlp = mlp_phase(torch, dev)

    # 12. the product path: SQLite → Train → Rank over HTTP, and the CLI ---
    pipeline_entries, pipe = pipeline_phase(torch, dev)

    # 13. the ML-20M-statistics protocol (scripts/parity_ml20m_torch.py) --
    ml20m_entries, ml20m = ml20m_phase(torch, dev)
    ml20m_auc = {k: round(v["auc"], 6) for k, v in ml20m["models"].items()}
    torch.cuda.empty_cache()

    # 14. the (data, model) mesh on one card: ranks over gloo ---------------
    mesh_entries, mesh_rmw = mesh_ranks_phase(torch, dev)
    rmw_share_lines({"K5": t6["K5"], "K6": t7["K6"]}, mesh_rmw)
    torch.cuda.empty_cache()

    # 15a. DLRM-DCNv2's kernels: K3's bags, the D = 128 compaction ---------
    dlrm_entries = dlrm_phase(torch, dev)

    # 15. the steps that promise not to wait, under the sync debug mode ----
    sync_phase(torch, dev)

    # 16. the headline and BASELINE #5 at the JAX bench's depth -------------
    del scorer, table, model, g_model
    torch.cuda.empty_cache()
    depth, bench_json = depth_phase(torch, dev)

    # 17. the JAX repo's kernel microbench and host-assembly profiler ------
    torch.cuda.empty_cache()
    kb = bench_kernels_phase(torch, dev)
    k1_err = max(k1_err, e6["K1"], e7["K1"])
    k2_err = max(k2_err, e6["K2"], e7["K2"])
    train_entries = []
    for key, name, src, replaces, times, counts, count_name in (
            ("K1", "row_gather (training forward)", "row_gather.cu",
             "goctr_tpu/ops/pallas/row_gather.py:74", t6, l6,
             "gather_rows forward"),
            ("K1", "row_gather (grouped training forward)", "row_gather.cu",
             "goctr_tpu/ops/pallas/row_gather.py:74", t7, l7,
             "gather_rows forward"),
            ("K1 read", "row_gather (row-update read)", "row_gather.cu",
             "goctr_tpu/ops/pallas/row_gather.py:74", t6, l6,
             "gather_rows read"),
            ("K2", "din_attention (training)", "din_attention.cu",
             "goctr_tpu/ops/pallas/din_attention.py:97", t6, l6,
             "din_attention_pool"),
            ("K2b", "din_attention_bwd", "din_attention_bwd.cu",
             "goctr_tpu/parallel/sparse_ctr.py:128", t6, l6,
             "din_attention_pool_bwd"),
            ("K4", "scatter_rows_packed", "row_scatter.cu",
             "goctr_tpu/ops/pallas/row_optimizer.py:824", t6, l6,
             "scatter_rows_packed"),
            ("compact_xla", "compact_xla (training)", "compact_xla.cu",
             "goctr_tpu/parallel/scanned.py:296-311", t6, l6,
             "compact_xla_rows"),
            ("compact_xla", "compact_xla (grouped training)",
             "compact_xla.cu", "goctr_tpu/parallel/scanned.py:296-311", t7,
             l7, "compact_xla_rows"),
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
        err_key = {"K2b": "K2b d_behaviors", "K1 read": "K1"}.get(key, key)
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
         "bound_by": din_bound_by, "library_ms": None},
    ] + train_entries + [k3_entry] + dense_entries + pipeline_entries
        + ml20m_entries + mesh_entries + dlrm_entries}
    served = pipe["bench_serving"]
    log(f"[done] scores/s plain {rate_plain:.1f}, packed {rate_packed:.1f}, "
        f"grouped {rate_grouped:.1f}; grouped launches {g_launches}; "
        f"err plain {err_plain:.3g}; smallest control reading headline "
        f"{min(ctl.values()):.3g}, grouped {min(g_ctl.values()):.3g}; "
        f"item2vec words/s {w2v['words_per_s_a']:.1f} (run A), "
        f"{w2v['words_per_s_b']:.1f} (run B), purity {w2v['purity']:.4f}; "
        f"MLP held-out AUC {mlp['adam']['auc']:.4f}, s an iteration lbfgs "
        f"{mlp['lbfgs']['s_iter']:.4f}, bfgs {mlp['bfgs']['s_iter']:.4f}, "
        f"cg {mlp['cg']['s_iter']:.4f}; pipeline MLP held-out AUC "
        f"{pipe['mlp']['auc']:.4f}, GAUC {pipe['mlp']['gauc']:.4f}, fit "
        f"{pipe['mlp']['fit_ex_per_s']:.1f} ex/s, Rank over HTTP p50 "
        f"{pipe['http']['p50_ms']:.2f} ms p99 {pipe['http']['p99_ms']:.2f} "
        f"ms; ml20m held-out AUC {ml20m_auc}; at depth eval_auc "
        f"{ {k: round(v['eval_auc'], 6) for k, v in depth.items()} }; "
        f"bench {bench_json['value']} ex/s, mfu_pct "
        f"{bench_json['mfu_pct']}, hbm_util_pct "
        f"{bench_json['hbm_util_pct']}; bench_serving "
        f"{served['scores'] / served['seconds']:.0f} scores/s; "
        f"bench_kernels {kb['bench_s']:.1f} s, assembly "
        f"{kb['rows_per_s']:.0f} rows/s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
