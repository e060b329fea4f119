#!/usr/bin/env python3
"""ML-20M quality-parity run of the PyTorch port, on one NVIDIA card by
default (the port's counterpart of scripts/parity_ml20m.py).

The reference's published results are three test-set scores on
MovieLens-20M (labelled "GAUC" in its README but computed as pooled
ROC-AUC over the test slice; its harness prints RocAuc32,
example/movielens/dinimpl_test.go:81):

    MLP 0.771258    YouTube-DNN 0.760381    DIN 0.790542

Protocol (dinimpl_test.go:20-86 with the ML-20M constants left in
comments): SampleCnt = 14,400,000 train rows, testCount = 5,610,000 eval
rows ordered by (timestamp, userId), a by-user 80/20 SQL split.

This script drives the same pipeline end to end on goctr_tpu_torch over
the ML-20M-statistics fixture (goctr_tpu_torch/data/ml20m.py): PreTrain
rating aggregates + ub-cache fill → item2vec pre-training (window 5, dim
16, one iteration, on the device) → vectorized sample assembly on the
host → MLP / YouTube-DNN / DIN training (RankerFitter, f16 storage, bf16
compute) → pooled AUC (the reference-comparable number) and per-user
GAUC on the test slice, both on the device (core/metrics.py). It prints
ONE JSON line: the keys of the JAX script's line, plus `device` (type,
the card's name and power limit) and the DIN `attention_impl`.

The shared stages run once, ahead of the per-model loop, as the JAX
script hoists them. The assembled matrices are cached beside the
database (`<db>.torch_x_<sample_cnt>_<test_cnt>.npz`, f16) so a second
run with other models or budgets skips them; the port's item2vec draws
are not JAX's, so the port keeps its own cache file.

Usage (from the repository root):
  python3 scripts/parity_ml20m_torch.py                 # full scale, card
  python3 scripts/parity_ml20m_torch.py --scale=0.1 --epochs=150 \\
      --early_stop=15 --mlp_epochs=20 --seq_act=relu --set beta=0.45 ...
  python3 scripts/parity_ml20m_torch.py --scale=0.004 --device=cpu \\
      --epochs=1 --cache_dir=/tmp/ml20m                 # a CPU smoke
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

REF = {"mlp": 0.771258, "youtube": 0.760381, "din": 0.790542}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--set", action="append", default=[], metavar="KNOB=V",
                   help="a SignalKnobs field (repeatable)")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--mlp_epochs", type=int, default=None,
                   help="the MLP's epochs (default: --epochs)")
    p.add_argument("--early_stop", type=int, default=4)
    p.add_argument("--batch", type=int, default=16384)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seq_act", default="",
                   help="activation of the YouTube-DNN and DIN towers")
    p.add_argument("--eval_sample", type=int, default=0,
                   help="score a uniform subsample of this many test rows")
    p.add_argument("--models", default="mlp,youtube,din")
    p.add_argument("--pred_bs", type=int, default=131072)
    p.add_argument("--sample_cnt", type=int, default=None)
    p.add_argument("--test_cnt", type=int, default=None)
    p.add_argument("--cache_dir", default=str(ROOT / "_ml20m_cache"))
    p.add_argument("--db", default=None)
    p.add_argument("--regen", action="store_true")
    p.add_argument("--no-xcache", dest="xcache", action="store_false")
    p.add_argument("--oversample", type=float, default=None)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--attention_impl", choices=("xla", "pallas"),
                   default="xla", help="the DIN pool: torch ops or K2/K2b")
    a = p.parse_args(argv)
    if a.mlp_epochs is None:
        a.mlp_epochs = a.epochs
    if a.sample_cnt is None:
        a.sample_cnt = int(14_400_000 * a.scale)
    if a.test_cnt is None:
        a.test_cnt = int(5_610_000 * a.scale)
    if a.oversample is None:
        a.oversample = 1.6 if a.scale < 0.2 else 1.25
    return a


def knobs_of(settings: list[str]):
    """(SignalKnobs, the overrides) from --set KNOB=V strings."""
    from goctr_tpu_torch.data.ml20m import SignalKnobs

    ftypes = {f.name: f.type for f in dataclasses.fields(SignalKnobs)}
    kw = {}
    for s in settings:
        k, v = s.split("=", 1)
        if k not in ftypes:
            raise SystemExit(f"--set {s}: SignalKnobs has no field {k!r}")
        kw[k] = int(float(v)) if ftypes[k] == "int" else float(v)
    return SignalKnobs(**kw), kw


def device_of(dev) -> dict:
    """The torch device's type, name and power limit (nvidia-smi's own
    words)."""
    import torch

    if dev.type != "cuda":
        return {"type": "cpu", "name": "cpu", "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return {"type": "cuda", "name": torch.cuda.get_device_name(dev),
            "power_limit": smi.rsplit(",", 1)[-1].strip()}


def read_test_slice(rec, db: Path, test_cnt: int):
    """The first test_cnt ratings_test rows by (timestamp, userId): from
    the generator's column sidecar when present, else by SQL. Returns
    (uid, iid, labels, ts)."""
    sidecar = Path(str(db) + ".cols.npz")
    if sidecar.exists():
        with np.load(sidecar) as z:
            return (z["test_uid"][:test_cnt], z["test_iid"][:test_cnt],
                    (z["test_rating"][:test_cnt] > 3.5).astype(np.float32),
                    z["test_ts"][:test_cnt])
    cur = rec.db.execute(
        "SELECT userId, movieId, rating, timestamp FROM ratings_test "
        "ORDER BY timestamp, userId ASC LIMIT ?", (test_cnt,))
    chunks = []
    while True:
        rows = cur.fetchmany(1_000_000)
        if not rows:
            break
        chunks.append(np.asarray(rows, np.float64))
    te = np.concatenate(chunks) if chunks else np.zeros((0, 4))
    return (te[:, 0].astype(np.int64), te[:, 1].astype(np.int64),
            (te[:, 2] > 3.5).astype(np.float32),      # BinarizeLabel
            te[:, 3].astype(np.int64))


def prepare(db: Path, sample_cnt: int, test_cnt: int, device, timings: dict,
            say=lambda msg: None):
    """The shared stages on MovielensRec(db): pre_train, item2vec on
    `device`, get_sample, then the test slice assembled at the PREDICT
    stage. Each stage's seconds go into `timings`. Returns (TrainSample,
    x_test f32, test labels, test user ids)."""
    from goctr_tpu_torch.data.movielens import MovielensRec
    from goctr_tpu_torch.recommend import rcmd
    from goctr_tpu_torch.recommend.rcmd import (
        Context, Stage, _assemble_batch, _State, get_sample)

    rec = MovielensRec(str(db), sample_cnt=sample_cnt)
    ctx = Context(stage=Stage.TRAIN)
    state = _State()

    # PreTrain: rating aggregates + train ub-cache (feature.go:255-296)
    t0 = time.perf_counter()
    rec.pre_train(ctx)
    timings["pre_train_s"] = time.perf_counter() - t0
    say(f"pre_train done ({len(rec.m_rating_map)} movies)")

    # item2vec pre-training (wordemb.go:9-32: SkipGram dim 16 window 5)
    t0 = time.perf_counter()
    state.item_embedding_map = rcmd.train_embedding(
        rec.item_seq_generator(ctx), window=rcmd.ITEM_EMB_WINDOW,
        dim=rcmd.ITEM_EMB_DIM, iters=1, device=device)
    timings["item2vec_s"] = time.perf_counter() - t0
    say(f"item2vec done ({len(state.item_embedding_map)} embeddings)")

    # sample assembly (GetSample rcmd.go:339-460, vectorized)
    t0 = time.perf_counter()
    sample = get_sample(rec, ctx, state)
    timings["assembly_s"] = time.perf_counter() - t0
    say(f"assembled {sample.rows} x {sample.x_cols} train matrix")

    # the test slice (dinimpl_test.go:52-61)
    t0 = time.perf_counter()
    te_uid, te_iid, te_y, te_ts = read_test_slice(rec, db, test_cnt)
    pctx = ctx.with_stage(Stage.PREDICT)
    rec.pre_rank(pctx)
    x_test = _assemble_batch(pctx, state, rec, te_uid, te_iid, te_ts)
    timings["test_assembly_s"] = time.perf_counter() - t0
    say(f"assembled {x_test.shape[0]} x {x_test.shape[1]} test matrix "
        f"(pos rate {te_y.mean():.3f})")
    return sample, x_test, te_y, te_uid


def trainer_config(name: str, epochs: int, args):
    """The protocol's TrainerConfig for one model: l2 1e-5 for the MLP
    (main.go:42-47), 1e-4 for the others (model.go:88); f16 storage."""
    from goctr_tpu_torch.models.trainer import TrainerConfig

    return TrainerConfig(batch_size=args.batch, epochs=epochs,
                         early_stop=args.early_stop, lr=args.lr,
                         l2=1e-5 if name == "mlp" else 1e-4,
                         store_dtype="float16", seed=args.seed)


def model_kwargs(name: str, args) -> dict:
    """The model fields the flags set: the YouTube-DNN and DIN towers'
    activation (the reference's are sigmoid, din.go:307-315) and the DIN
    pool."""
    kw = {}
    if name != "mlp" and args.seq_act:
        kw["activation"] = args.seq_act
    if name == "din":
        kw["attention_impl"] = args.attention_impl
    return kw


def run_models(args, sample, x_test, te_y, te_uid, timings, device,
               say=lambda msg: None) -> dict:
    """Fit each of --models by RankerFitter and score the test slice on
    the device. Returns {"auc", "gauc", "train_examples_per_s",
    "peak_device_gb"}, each by model name."""
    import torch

    from goctr_tpu_torch.core.metrics import gauc_device, roc_auc_device
    from goctr_tpu_torch.recommend.rcmd import RankerFitter

    # --eval_sample=N scores a uniform N-row subsample of the test slice
    # (AUC/GAUC estimator noise at 1M rows is ±~0.001)
    es = args.eval_sample
    if es and es < x_test.shape[0]:
        sel = np.sort(np.random.default_rng(0).permutation(
            x_test.shape[0])[:es])
        x_test, te_y, te_uid = x_test[sel], te_y[sel], te_uid[sel]
    y_dev = torch.from_numpy(np.asarray(te_y, np.float32)).to(device)
    uid_dev = torch.from_numpy(np.asarray(te_uid)).to(device)
    out = {"auc": {}, "gauc": {}, "train_examples_per_s": {},
           "peak_device_gb": {}}
    cuda = device.type == "cuda"
    for name in args.models.split(","):
        epochs = args.mlp_epochs if name == "mlp" else args.epochs
        fitter = RankerFitter(name, trainer_config(name, epochs, args),
                              use_bf16=True, device=device,
                              **model_kwargs(name, args))
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
            held = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        ranker = fitter.fit(sample)
        dt = time.perf_counter() - t0
        n_ep = len(ranker.epoch_times)
        rate = n_ep * sample.rows / max(sum(ranker.epoch_times), 1e-9)
        out["train_examples_per_s"][name] = rate
        timings[f"train_{name}_s"] = dt
        say(f"{name}: {n_ep} epochs in {dt:.1f}s ({rate:,.0f} ex/s), "
            f"loss {ranker.loss_curve[-1]:.4f}")
        t0 = time.perf_counter()
        scores = ranker.predict(x_test, batch_size=args.pred_bs)
        s_dev = torch.from_numpy(scores).to(device)
        out["auc"][name] = float(roc_auc_device(s_dev, y_dev))
        out["gauc"][name] = float(gauc_device(s_dev, y_dev, uid_dev))
        timings[f"eval_{name}_s"] = time.perf_counter() - t0
        if cuda:
            out["peak_device_gb"][name] = (
                torch.cuda.max_memory_allocated(device) - held) / 1e9
        say(f"{name}: test AUC {out['auc'][name]:.6f} GAUC "
            f"{out['gauc'][name]:.6f} (ref {REF.get(name, float('nan'))})")
        del ranker, fitter, s_dev
    return out


def main(argv=None) -> None:
    t_start = time.perf_counter()
    args = parse_args(argv)
    from goctr_tpu_torch.core.dtypes import resolve_device
    from goctr_tpu_torch.data.ml20m import generate_ml20m_fixture
    from goctr_tpu_torch.models.base import SampleInfo, TrainSample

    device = resolve_device(args.device)         # raises without a card
    dev_info = device_of(device)
    knobs, knobs_kw = knobs_of(args.set)

    def say(msg):
        if not args.quiet:
            print(f"[parity +{time.perf_counter() - t_start:7.1f}s] {msg}",
                  file=sys.stderr, flush=True)

    cache_dir = Path(args.cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    ktag = "_".join(f"{k}{v:g}" for k, v in sorted(knobs_kw.items()))
    db = Path(args.db or cache_dir / f"ml20m_s{args.scale:g}_{ktag}.db")
    timings = {}
    if not db.exists() or args.regen:
        t0 = time.perf_counter()
        stats = generate_ml20m_fixture(
            db, scale=args.scale, knobs=knobs, verbose=not args.quiet,
            oversample=args.oversample)
        timings["generate_s"] = time.perf_counter() - t0
        say(f"fixture: {json.dumps(stats)}")

    xcache = Path(f"{db}.torch_x_{args.sample_cnt}_{args.test_cnt}.npz")
    if xcache.exists() and args.xcache:
        with np.load(xcache) as z:
            sample = TrainSample(x=z["x"], y=z["y"], info=SampleInfo(
                *[tuple(int(v) for v in r) for r in z["info"]]))
            x_test = z["x_test"].astype(np.float32)
            te_y, te_uid = z["te_y"], z["te_uid"]
        say(f"loaded cached matrices {sample.x.shape} / {x_test.shape}")
    else:
        sample, x_test, te_y, te_uid = prepare(
            db, args.sample_cnt, args.test_cnt, device, timings, say)
        if args.xcache:
            info = sample.info
            np.savez(xcache, x=sample.x.astype(np.float16), y=sample.y,
                     info=np.asarray([info.user_profile_range,
                                      info.user_behavior_range,
                                      info.item_feature_range,
                                      info.ctx_feature_range]),
                     x_test=x_test.astype(np.float16), te_y=te_y,
                     te_uid=te_uid)
            say("cached assembled matrices")

    res = run_models(args, sample, x_test, te_y, te_uid, timings, device, say)
    print(json.dumps({
        "metric": "ml20m_quality_parity",
        "auc": res["auc"],                # reference-comparable pooled AUC
        "gauc": res["gauc"],              # per-user GAUC
        "ref_auc": REF,
        "train_examples_per_s": res["train_examples_per_s"],
        "peak_device_gb": res["peak_device_gb"],
        "scale": args.scale, "sample_cnt": sample.rows,
        "test_cnt": int(min(x_test.shape[0], args.eval_sample or
                            x_test.shape[0])),
        "timings_s": timings,
        "wall_s": time.perf_counter() - t_start,
        "knobs": dataclasses.asdict(knobs),
        "device": dev_info,
        "attention_impl": args.attention_impl,
    }), flush=True)


if __name__ == "__main__":
    main()
