#!/usr/bin/env python3
"""Epoch seconds and a profiled step's idle share of the scanned
trainer's dedup, sorted and plain update modes on one card, at
chip_smoke.py phase 6's headline: SparseCTR 10M × 64, batch 65,536,
16 × 65,536 rows of the JAX bench workload (`split_workload`), one
epoch in each mode from one start (a [V, 64] table drawn from seed 0)
after one untimed warm-up epoch (dedup: the process's first epoch pays
for cuBLAS's and the allocator's first calls), then 3 profiled steps of
the trained result (`profile_steps`: device busy over wall, after a
warm-up step). With --scatter, also the device time of one
`scatter_add_rows` call against the masked version it replaced (a copy
below), CUDA events around 10 calls after 2, on three streams of
2,162,688 ids (phase 6's batch × 33): the mesh's stage 4 on a 2×2 shard
(12% distinct real ids ascending, the rest past the shard's 5M rows),
the sorted mode's with a quarter -1 pads first, and the plain mode's
(no id dropped; zipf-like over 10M), each at D = 64 and on the
accumulator's one column.

    python3 scripts/sync_epochs.py [--root DIR] [--tag NAME] [--epochs N]
                                   [--scatter]

--root is the checkout whose goctr_tpu_torch and chip_smoke.py are
imported (default: this script's repository), so that one call can time
a parent's `git archive` beside this tree: run parent, change, change,
parent. --epochs N trains N epochs a mode (from the same start each
time) and reports each. Prints the card's name and power limit, then one
JSON line: {"tag", "root", "card", "modes": {mode: {"epoch_s": [...],
"loss": first epoch's, "wall_ms", "busy_ms", "idle"}}, "scatter":
{stream: {D: {"ms", "mask_ms"}}}}. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

MODES = ("dedup", "sorted", "plain")
SCATTER_N = 65_536 * 33


def mask_scatter_add_rows(table, ids, rows):
    """scatter_add_rows before it dropped rows without a mask (the card's
    path): a boolean mask, whose nonzero makes the host wait."""
    keep = (ids >= 0) & (ids < table.shape[0])
    ids, rows = ids[keep].long(), rows[keep]
    return table.index_put_((ids,), rows, accumulate=True)


def scatter_times(torch, dev) -> dict:
    """{stream: {D: {"ms", "mask_ms"}}} (module docstring)."""
    import numpy as np

    from goctr_tpu_torch.ops.scatter import scatter_add_rows

    rng = np.random.default_rng(0)
    n, v = SCATTER_N, 10_000_000
    hot = rng.integers(0, v // 10, n)
    zipf = np.where(rng.random(n) < 0.5, hot, rng.integers(0, v, n))
    real = np.sort(rng.choice(v // 2, int(0.12 * n), replace=False))
    streams = {
        "stage 4 (2x2 shard)": (v // 2, np.concatenate(
            [real, v // 2 + 1 + np.arange(n - real.size)])),
        "sorted, 25% pads": (v, np.sort(np.where(rng.random(n) < 0.25, -1,
                                                 zipf))),
        "plain, none dropped": (v, zipf),
    }
    out = {}
    for name, (rows_v, ids) in streams.items():
        ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
        out[name] = {}
        for d in (64, 1):
            table = torch.zeros(rows_v, d, device=dev)
            rows = torch.randn(n, d, device=dev)
            res = {}
            for key, fn in (("ms", scatter_add_rows),
                            ("mask_ms", mask_scatter_add_rows)):
                for _ in range(2):
                    fn(table, ids, rows)
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(10):
                    fn(table, ids, rows)
                t1.record()
                torch.cuda.synchronize()
                res[key] = t0.elapsed_time(t1) / 10
            out[name][d] = res
            del table, rows
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--scatter", action="store_true")
    args = ap.parse_args()
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sync_epochs: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from goctr_tpu_torch.models.trainer import TrainerConfig
    from goctr_tpu_torch.parallel import scanned as sc
    from goctr_tpu_torch.parallel.sparse_ctr import SparseCTR

    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)
    hl = cs.HEADLINE
    sample = cs.split_workload(cs.TRAIN_ROWS, hl["item_vocab"],
                               hl["behavior_len"], hl["u_profile_dim"],
                               hl["ctx_dim"], seed=cs.SEED)[0]
    cfg = TrainerConfig(batch_size=cs.TRAIN_BATCH, epochs=1, early_stop=0,
                        lr=1e-3, shuffle=True, seed=cs.SEED)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    model0 = SparseCTR(**hl, compute_dtype=torch.bfloat16, device=dev)
    start = sc.TrainedScanned(model=model0, table=model0.init_params(gen),
                              loss_curve=[])
    bs = cs.TRAIN_BATCH
    batches = []
    for b in range(4):
        sl = slice(b * bs, (b + 1) * bs)
        batches.append([torch.from_numpy(np.ascontiguousarray(a[sl])).to(dev)
                        for a in (sample.user_profile, sample.behavior_ids,
                                  sample.item_ids, sample.ctx,
                                  sample.labels)]
                       + [torch.ones(bs, device=dev)])

    def train(mode):
        topt = sc.TableOptConfig(kind="adagrad", lr=cs.TABLE_LR,
                                 update_mode=mode)
        return topt, sc.train_sparse_scanned(
            SparseCTR(**hl, compute_dtype=torch.bfloat16, device=dev),
            sample, cfg, topt, resume_from=start, device=dev)

    train("dedup")
    out = {}
    for mode in MODES:
        times, losses = [], []
        for _ in range(args.epochs):
            topt, r = train(mode)
            times.append(r.epoch_times[0])
            losses.append(r.loss_curve[0])
        state = [x.clone() for x in r.opt_state]
        solver = sc.make_trainer_solver(cfg)

        def step(i, r=r, topt=topt, solver=solver):
            nonlocal state
            _, _, state = sc.train_step(r.model, r.table, solver, state,
                                        *batches[i % 4], topt, acc=r.acc)

        prof = cs.profile_steps(torch, step, f"sync-epochs {mode}")
        out[mode] = {"epoch_s": times, "loss": losses[0],
                     "wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
                     "idle": max(0.0, 1 - prof["busy_ms"] / prof["wall_ms"])}
        del r, state
        torch.cuda.empty_cache()
    line = {"tag": args.tag, "root": root, "card": cs.card_line(),
            "modes": out}
    if args.scatter:
        line["scatter"] = scatter_times(torch, dev)
    print(line["card"], flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
