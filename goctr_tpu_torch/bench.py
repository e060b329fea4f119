"""Benchmark harness of the port: prints the card's line, then ONE JSON line
(the counterpart of the JAX repository's root bench.py, with its flags, its
workload, its keys in its order).

    python3 -m goctr_tpu_torch.bench [--smoke] [--batch=65536]
        [--rows=5000000] [--vocab=10000000] [--t=32] [--epochs=4]
        [--eval_rows=250000] [--mode=fused] [--zipf=1] [--dim=64]
        [--eval=noisy|clean] [--compact=auto|N] [--tlr=2.0] [--rmw=split]
        [--compact_impl=xla] [--gather=take] [--sorted_gather]
        [--no-eval] [--no-serve-bench] [--cpu]

Headline workload: the JAX bench's sparse CTR training on one card — a
10M-row learned embedding table trained jointly with a (1024, 512, 256)
DIN-attention tower in bf16 over 5M raw-id examples of a planted-parity
draw (zipf ids, noisy labels), by the scanned device-resident trainer;
then the held-out metrics and two serving rates of the trained model.
BASELINE #5's single-card variant is `--vocab=100000000 --dim=16
--rows=1000000 --batch=16384 --epochs=3`.

  value                   examples/s, steady state (the epochs after the
                          first, which also carries the kernels' build)
  model_flops_per_example analytic fwd+bwd tower FLOPs (gather excluded)
  mfu_pct                 value × flops/ex ÷ the card's bf16 dense peak
  hbm_util_pct            value × bytes/ex ÷ the card's HBM rate
  vs_baseline             vs the Go reference's CPU run (79,948 samples in
                          28 s)

Runs on the card; `--cpu` runs on the CPU (the kernels' plain versions),
where mfu_pct and hbm_util_pct are null: there is no card peak to divide
by. Without a card and without --cpu it exits nonzero. `--gather` takes
only `take`: the port has one gather, kernel K1 (TableOptConfig's
gather_impl is a deliberate gap).
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from goctr_tpu_torch.parallel.sparse_trainer import SparseSample

# the Go reference's end-to-end CPU training run: 79,948 samples in 28 s
# (its README.md:160-165); a CPU figure, not a TPU one
BASELINE_EXAMPLES_PER_S = 79_948 / 28.0
# (bf16 dense tensor FLOP/s, HBM bytes/s) by torch.cuda.get_device_name():
# the H100 SXM5 data sheet (989.4 TFLOP/s dense; 1,979 is with sparsity)
CARD_PEAKS = {"NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12)}
# serving: candidates a request (the reference's api.go:106-131), requests
# a score_batch, at most this many requests
SERVE_K, SERVE_R, SERVE_MAX_REQUESTS = 400, 32, 256
# the held-out control: scores against a fixed permutation of the labels
CONTROL_SEED = 1
# value flags with bench.py's defaults, and its switches; --cpu is the
# port's own
VALUE_FLAGS = {"batch": "65536", "rows": "5000000", "vocab": "10000000",
               "t": "32", "epochs": "4", "eval_rows": "250000",
               "mode": "fused", "zipf": "1", "dim": "64", "eval": "noisy",
               "compact": "auto", "tlr": "2.0", "rmw": "split",
               "compact_impl": "xla", "gather": "take"}
SWITCHES = ("smoke", "sorted_gather", "no-eval", "no-serve-bench", "cpu")
GATHER_GAP = ("the port has one gather, kernel K1 (--gather=take); "
              "TableOptConfig.gather_impl is a deliberate gap of the port")


# ------------------------------------------------------------ workload --
def _zipf_ranks(rng, shape, n_ranks, s=1.05):
    """Bounded-zipf rank draws in [0, n_ranks): P(r) ≈ (r+1)^-s — the
    popularity law of real CTR traffic. Closed-form inverse CDF of the
    continuous bounded power law (O(1) a draw)."""
    u = rng.random(shape)
    t = float(n_ranks) ** (1.0 - s)              # V^(1-s) < 1 for s > 1
    x = (1.0 - u * (1.0 - t)) ** (1.0 / (1.0 - s))
    return np.minimum(x.astype(np.int64) - 1, n_ranks - 1).clip(0)


def make_workload(n, vocab, t, u, c, seed=0, zipf=True, noisy=True):
    """Planted-parity sparse sample (the JAX bench's draw, bit for bit):
    label = item parity == the user's taste parity, which 85% of the
    behaviors carry, so the benchmark is a real learning workload.

    zipf=True draws item popularity from a bounded zipf (s = 1.05) over the
    vocab, hot ranks scattered across the id space by a fixed
    multiplicative-hash permutation (hot rows repeat within a batch);
    zipf=False draws ids uniformly.

    noisy=True (--eval=clean disables) flips 15% of labels and plants a
    popularity confound (hot-rank items lean positive), so the held-out
    AUC is a regression bar below the oracle's ceiling rather than a
    learns-at-all gate.

    Returns (sample, uids, oracle_scores): the oracle scores are the
    Bayes-optimal P(label = 1) under the generative model (rule +
    confound), whose AUC is the ceiling."""
    rng = np.random.default_rng(seed)
    uids = rng.integers(0, max(n // 256, 1), n).astype(np.int32)
    user_taste = rng.integers(0, 2, max(n // 256, 1))
    taste = user_taste[uids]
    half = vocab // 2
    prime = 2_654_435_761            # Knuth multiplicative hash, odd
    if zipf:
        # bijective rank→slot scatter (gcd(prime, half)==1 for even half)
        def draw(shape):
            r = _zipf_ranks(rng, shape, half)
            return (r * prime) % half, r
    else:
        def draw(shape):
            v = rng.integers(0, half, shape, dtype=np.int64)
            return v, v
    b_slot, _ = draw((n, t))
    b_alt, _ = draw((n, t))
    bids = np.where(
        rng.random((n, t)) < 0.85,
        b_slot * 2 + taste[:, None],
        b_alt * 2 + rng.integers(0, 2, (n, t))).astype(np.int32)
    i_slot, i_rank = draw((n,))
    iids = (i_slot * 2 + rng.integers(0, 2, n)).astype(np.int32)
    parity = ((iids % 2) == taste)
    if noisy:
        # popularity confound: hot items (top ~10% of zipf ranks) lean
        # positive regardless of the rule; plus 15% label flips
        hot = i_rank < max(half // 10, 1)
        p_pos = np.where(parity, 0.85, 0.15) + np.where(hot, 0.10, -0.01)
        p_pos = p_pos.clip(0.02, 0.98)
        y = (rng.random(n) < p_pos).astype(np.float32)
        oracle = p_pos.astype(np.float32)
    else:
        y = parity.astype(np.float32)
        oracle = y
    return SparseSample(
        user_profile=rng.random((n, u), dtype=np.float32),
        behavior_ids=bids, item_ids=iids,
        ctx=rng.random((n, c), dtype=np.float32), labels=y), uids, oracle


class Draw(NamedTuple):
    """One draw split as the bench splits it: the first rows train, the
    last are held out (same users and popularity on both sides)."""
    sample: SparseSample
    eval_sample: SparseSample
    eval_uids: np.ndarray
    eval_oracle: np.ndarray


def split_rows(workload, n: int) -> Draw:
    """make_workload's (sample, uids, oracle) split after row n."""
    full, uids, oracle = workload

    def part(sl):
        return SparseSample(full.user_profile[sl], full.behavior_ids[sl],
                            full.item_ids[sl], full.ctx[sl], full.labels[sl])

    return Draw(part(slice(None, n)), part(slice(n, None)), uids[n:],
                oracle[n:])


def split_workload(n, vocab, t, u, c, seed=0, eval_rows=250_000, zipf=True,
                   noisy=True) -> Draw:
    """n + eval_rows rows drawn as one, split after row n."""
    return split_rows(make_workload(n + eval_rows, vocab, t, u, c, seed,
                                    zipf, noisy), n)


def first_batch_ids(sample: SparseSample, batch: int) -> tuple[int, int]:
    """(unique ids, ids) of the first batch's behaviors and items."""
    b0 = np.concatenate([sample.behavior_ids[:batch].ravel(),
                         sample.item_ids[:batch]])
    return len(np.unique(b0[b0 >= 0])), len(b0)


def bench_compact_cap(sample: SparseSample, batch: int) -> int:
    """The auto compact_cap: the first batch's unique ids + 15%, rounded up
    to a multiple of 1024."""
    uniq0, _ = first_batch_ids(sample, batch)
    return -(-int(uniq0 * 1.15) // 1024) * 1024


# ---------------------------------------------------------------- flags --
@dataclasses.dataclass(frozen=True)
class Settings:
    """The run bench.py's flags describe (shapes resolved: --smoke fixes
    its own and ignores the shape flags)."""
    rows: int
    vocab: int
    t: int
    u: int
    c: int
    hidden: tuple[int, ...]
    batch: int
    epochs: int
    eval_rows: int
    dim: int
    mode: str
    zipf: bool
    noisy: bool
    sorted_gather: bool
    compact: str            # "auto" or a cap (0: off)
    tlr: float
    rmw: str
    compact_impl: str
    smoke: bool
    eval: bool
    serve: bool
    cpu: bool

    def model_cfg(self) -> dict:
        return dict(item_vocab=self.vocab, emb_dim=self.dim,
                    u_profile_dim=self.u, ctx_dim=self.c,
                    behavior_len=self.t, hidden=self.hidden,
                    activation="relu")

    def draw(self) -> Draw:
        return split_workload(self.rows, self.vocab, self.t, self.u, self.c,
                              eval_rows=self.eval_rows, zipf=self.zipf,
                              noisy=self.noisy)

    def compact_cap(self, sample: SparseSample) -> int:
        """The auto cap in fused mode outside --smoke, else 0; --compact=N
        overrides, --compact=0 disables."""
        if self.compact != "auto":
            return int(self.compact)
        if self.mode == "fused" and not self.smoke:
            return bench_compact_cap(sample, self.batch)
        return 0


def settings(argv: list[str]) -> Settings:
    """bench.py's flags (`--name=value` and switches) read from argv. An
    unknown flag, or a --gather other than take, exits nonzero."""
    for a in argv:
        name, eq, _ = a[2:].partition("=")
        if not a.startswith("--") or not (
                name in VALUE_FLAGS and eq or a[2:] in SWITCHES):
            raise SystemExit(f"bench: unknown argument {a!r}")

    def arg(name: str) -> str:
        for a in argv:
            if a.startswith(f"--{name}="):
                return a.split("=", 1)[1]
        return VALUE_FLAGS[name]

    if arg("gather") != "take":
        raise SystemExit(f"bench: --gather={arg('gather')}: {GATHER_GAP}")
    smoke = "--smoke" in argv
    if smoke:
        shapes = dict(rows=20_000, vocab=10_000, t=8, u=8, c=4,
                      hidden=(64, 32), batch=4096, epochs=3,
                      eval_rows=4_000, dim=64)
    else:
        shapes = dict(rows=int(arg("rows")), vocab=int(arg("vocab")),
                      t=int(arg("t")), u=48, c=16, hidden=(1024, 512, 256),
                      batch=int(arg("batch")), epochs=int(arg("epochs")),
                      eval_rows=int(arg("eval_rows")), dim=int(arg("dim")))
    if shapes["epochs"] < 2:
        raise SystemExit("bench: --epochs must be 2 or more (the steady "
                         "rate is taken over the epochs after the first)")
    return Settings(
        **shapes, mode=arg("mode"), zipf=arg("zipf") == "1",
        noisy=arg("eval") != "clean",
        sorted_gather="--sorted_gather" in argv, compact=arg("compact"),
        tlr=float(arg("tlr")), rmw=arg("rmw"),
        compact_impl=arg("compact_impl"), smoke=smoke,
        eval="--no-eval" not in argv, serve="--no-serve-bench" not in argv,
        cpu="--cpu" in argv)


# ------------------------------------------------------------------ run --
def counted_kernels() -> dict:
    """The launch-counted wrappers of the training paths, by name (each
    adds one to `.launches` where it launches its kernel)."""
    from goctr_tpu_torch.ops.kernels import compact as k9
    from goctr_tpu_torch.ops.kernels import compact_xla as kx
    from goctr_tpu_torch.ops.kernels import din_attention as k2
    from goctr_tpu_torch.ops.kernels import embedding_lookup as k3
    from goctr_tpu_torch.ops.kernels import row_gather as k1
    from goctr_tpu_torch.ops.kernels import row_optimizer as ro
    from goctr_tpu_torch.ops.kernels import run_optimizer as k8

    return {f.__name__: f for f in (
        k1.gather_rows, k2.din_attention_pool, k2.din_attention_pool_bwd,
        ro.scatter_rows_packed, k9.compact_runsums_block,
        kx.compact_xla_rows, ro.apply_row_updates, ro.apply_line_updates,
        ro.apply_csum_updates, k8.apply_run_updates, k3.fused_gather_pool)}


@dataclasses.dataclass
class Run:
    """A trained bench run: the ranker and what the run read."""
    settings: Settings
    draw: Draw
    ranker: object                  # parallel/scanned.TrainedScanned
    seed: int
    compact_cap: int
    first_batch: tuple[int, int]    # (unique ids, ids) of the first batch
    launches: dict                  # kernel launches during the training
    peak_gb: Optional[float]        # peak device memory (None on the CPU)

    @property
    def examples_per_s(self) -> float:
        steady = self.ranker.epoch_times[1:]
        return len(steady) * self.draw.sample.rows / sum(steady)

    def readings(self) -> dict:
        """The run's shapes, settings and readings (JSON-ready)."""
        s, r = self.settings, self.ranker
        rows = self.draw.sample.rows
        steps = -(-rows // s.batch)
        steady = r.epoch_times[1:]
        return dict(
            rows=rows, eval_rows=self.draw.eval_sample.rows, batch=s.batch,
            epochs=s.epochs, steps_per_epoch=steps,
            pad_rows=steps * s.batch - rows, seed=self.seed, mode=s.mode,
            rmw=s.rmw, compact_impl=s.compact_impl,
            compact_cap=self.compact_cap, vocab=s.vocab, dim=s.dim,
            table_group=r.packed_group, loss_curve=r.loss_curve,
            epoch_s=r.epoch_times, steady_ex_per_s=self.examples_per_s,
            step_ms=sum(steady) / (steps * len(steady)) * 1e3,
            overflow=r.update_overflow_max, peak_gb=self.peak_gb,
            launches=self.launches)


def train(s: Settings, draw: Draw, device: str | torch.device = "cuda",
          seed: int = 0) -> Run:
    """bench.py's training run on `draw`: SparseCTR at the settings'
    widths in bf16, TrainerConfig(batch, epochs, early_stop 0, lr 1e-3,
    shuffled, `seed`), the table's adagrad at --tlr with the update mode,
    row update, compaction and compact_cap the flags give. An overflowing
    compact_cap is reported on stderr."""
    from goctr_tpu_torch.core.dtypes import resolve_device
    from goctr_tpu_torch.models.trainer import TrainerConfig
    from goctr_tpu_torch.parallel.scanned import (
        TableOptConfig, train_sparse_scanned)
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR

    dev = resolve_device(device)
    cap = s.compact_cap(draw.sample)
    cfg = TrainerConfig(batch_size=s.batch, epochs=s.epochs, early_stop=0,
                        lr=1e-3, shuffle=True, seed=seed)
    topt = TableOptConfig(kind="adagrad", lr=s.tlr, update_mode=s.mode,
                          sorted_gather=s.sorted_gather, rmw_impl=s.rmw,
                          compact_impl=s.compact_impl, compact_cap=cap)
    counted = counted_kernels()
    before = {k: f.launches for k, f in counted.items()}
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()       # the allocator's stats exist from here on
        torch.cuda.reset_peak_memory_stats(dev)
    ranker = train_sparse_scanned(
        SparseCTR(**s.model_cfg(), compute_dtype=torch.bfloat16,
                  device=dev), draw.sample, cfg, topt, device=dev)
    launches = {k: f.launches - before[k] for k, f in counted.items()}
    if ranker.update_overflow_max:
        print(f"WARNING: compact_cap overflowed "
              f"({ranker.update_overflow_max} rows dropped)",
              file=sys.stderr)
    return Run(settings=s, draw=draw, ranker=ranker, seed=seed,
               compact_cap=cap,
               first_batch=first_batch_ids(draw.sample, s.batch),
               launches=launches,
               peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9 if cuda
                        else None))


def evaluate(run: Run, device: str | torch.device = "cuda") -> dict:
    """The held-out rows scored by the trained ranker: eval_auc and
    eval_gauc (and with noisy labels the oracle's eval_auc_ceiling) by the
    device metrics, their largest distance from the numpy metrics
    (metric_err), and the AUC against a fixed permutation of the held-out
    labels (control_auc, chance if the scores carry no label leak)."""
    from goctr_tpu_torch.core import metrics as mt
    from goctr_tpu_torch.core.dtypes import resolve_device

    dev = resolve_device(device)
    ev = run.draw.eval_sample
    scores = run.ranker.predict(ev)
    y = np.asarray(ev.labels, np.float32)
    s_d = torch.from_numpy(scores).to(dev)
    y_d = torch.from_numpy(y).to(dev)
    out = {"eval_auc": float(mt.roc_auc_device(s_d, y_d)),
           "eval_gauc": float(mt.gauc_device(
               s_d, y_d, torch.from_numpy(run.draw.eval_uids).to(dev)))}
    if run.settings.noisy:
        out["eval_auc_ceiling"] = float(mt.roc_auc_device(
            torch.from_numpy(run.draw.eval_oracle).to(dev), y_d))
    out["metric_err"] = max(
        abs(out["eval_auc"] - mt.roc_auc_score(y, scores)),
        abs(out["eval_gauc"] - mt.gauc_np(y, scores, run.draw.eval_uids)))
    out["control_auc"] = float(mt.roc_auc_score(
        np.random.default_rng(CONTROL_SEED).permutation(y), scores))
    return out


def serving_request(ev: SparseSample, i: int):
    """bench.py's request i over the held-out rows: row i's profile,
    behaviors and ctx, and SERVE_K candidates from a sliding window of
    the held-out items."""
    row = i % ev.rows
    return (ev.user_profile[row], ev.behavior_ids[row], ev.ctx[row],
            ev.item_ids[i * SERVE_K % max(ev.rows - SERVE_K, 1):][:SERVE_K])


def serving_batch(scorer, ev: SparseSample, i0: int) -> list[np.ndarray]:
    """SERVE_R requests from i0 through one score_batch (scores on the
    host)."""
    rs = [serving_request(ev, i0 + r) for r in range(SERVE_R)]
    return scorer.score_batch(
        np.stack([r[0] for r in rs]), np.stack([r[1] for r in rs]),
        np.stack([r[2] for r in rs]), [r[3] for r in rs])


def serve_rates(run: Run, device: str | torch.device = "cuda") -> dict:
    """Model-scoring throughput of the trained ranker: the whole held-out
    slice in 400-row predict calls (serving_scores_per_s), and requests of
    400 candidates, 32 to a DeviceScorer batch, at most 256 requests,
    after one warm-up batch (serving_device_scores_per_s). Both clocks
    stop after the scores are on the host."""
    from goctr_tpu_torch.serve.scorer import DeviceScorer

    ev = run.draw.eval_sample
    t0 = time.perf_counter()
    run.ranker.predict(ev, batch_size=SERVE_K)
    out = {"serving_scores_per_s": ev.rows / (time.perf_counter() - t0)}
    scorer = DeviceScorer.from_scanned(run.ranker, device=device)
    n_req = min(ev.rows // SERVE_K, SERVE_MAX_REQUESTS)
    serving_batch(scorer, ev, 0)
    t0 = time.perf_counter()
    done = 0
    for i0 in range(0, n_req, SERVE_R):
        done += sum(len(o) for o in serving_batch(scorer, ev, i0))
    out["serving_device_scores_per_s"] = done / (time.perf_counter() - t0)
    return out


def card_peaks(name: str) -> tuple[float, float]:
    """(bf16 dense FLOP/s, HBM bytes/s) of the card named `name`."""
    if name not in CARD_PEAKS:
        raise ValueError(f"no peak rates known for the card {name!r}; add "
                         f"it to CARD_PEAKS")
    return CARD_PEAKS[name]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def bench_line(run: Run, metrics: Optional[dict], rates: Optional[dict],
               peaks: Optional[tuple[float, float]]) -> dict:
    """bench.py's JSON line (its keys, in its order, rounded as it rounds
    them) from a run, its held-out metrics and serving rates (None: left
    out) and the card's peaks (None on the CPU: mfu_pct and hbm_util_pct
    null)."""
    from goctr_tpu_torch.parallel.scanned import (
        model_bytes_per_example, model_flops_per_example)

    s = run.settings
    model = run.ranker.model
    eps = run.examples_per_s
    flops_ex = model_flops_per_example(model, s.t)
    uniq0, n_ids = run.first_batch
    # fused: only the first batch's unique targets move row-update bytes
    real_frac = uniq0 / max(n_ids, 1) if s.mode == "fused" else 1.0
    bytes_ex = model_bytes_per_example(
        model, s.t, s.mode, real_frac=real_frac,
        compact_frac=(run.compact_cap / max(n_ids, 1) if run.compact_cap
                      else 0.0))
    extra = {}
    if metrics is not None:
        extra.update({k: round(metrics[k], 4) for k in
                      ("eval_auc", "eval_gauc", "eval_auc_ceiling")
                      if k in metrics})
    if rates is not None:
        extra.update({k: round(v, 1) for k, v in rates.items()})
    return {
        "metric": "sparse_din_train_examples_per_s",
        "value": round(eps, 1),
        "unit": "examples/s",
        "vs_baseline": round(eps / BASELINE_EXAMPLES_PER_S, 2),
        "model_flops_per_example": round(flops_ex, 0),
        "mfu_pct": (None if peaks is None else
                    round(100.0 * eps * flops_ex / peaks[0], 2)),
        "model_bytes_per_example": round(bytes_ex, 0),
        "hbm_util_pct": (None if peaks is None else
                         round(100.0 * eps * bytes_ex / peaks[1], 2)),
        "workload": (f"sparse_ctr vocab={s.vocab} dim={s.dim} T={s.t} "
                     f"hidden={'x'.join(map(str, s.hidden))} bf16 "
                     f"rows={s.rows} batch={s.batch} table_update={s.mode} "
                     f"ids={'zipf1.05' if s.zipf else 'uniform'} loss_last="
                     f"{round(run.ranker.loss_curve[-1], 4)}"),
        **extra,
    }


def main(argv: list[str]) -> int:
    s = settings(argv)
    if not s.cpu and not torch.cuda.is_available():
        print("bench: torch.cuda.is_available() is False; pass --cpu to "
              "run on the CPU", file=sys.stderr)
        return 2
    dev = torch.device("cpu" if s.cpu else "cuda")
    peaks = None
    if not s.cpu:
        peaks = card_peaks(torch.cuda.get_device_name(dev))
        print(card_line(), flush=True)
    run = train(s, s.draw(), dev)
    metrics = evaluate(run, dev) if s.eval else None
    rates = serve_rates(run, dev) if s.serve else None
    print(json.dumps(bench_line(run, metrics, rates, peaks)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
