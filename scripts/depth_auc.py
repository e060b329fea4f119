#!/usr/bin/env python3
"""Held-out AUC of the port's scanned trainer at the JAX bench's own
depth, on one card: bench.py's training run (its flags, its defaults
and its draw, through goctr_tpu_torch.bench's `Settings`, `train` and
`evaluate`) with a trainer seed of your choice.

    python3 scripts/depth_auc.py [--rows=5000000] [--vocab=10000000]
        [--dim=64] [--batch=65536] [--epochs=4] [--eval_rows=250000]
        [--mode=fused] [--rmw=split] [--compact_impl=xla] [--seed=0]

The defaults are bench.py's headline; BASELINE #5 is `--vocab=100000000
--dim=16 --rows=1000000 --batch=16384 --epochs=3`, its converged point
`--rows=5000000 --epochs=8` with the same vocab, dim and batch. The
workload's draw is seed 0 as in bench.py (bit for bit its rows);
--seed sets the trainer's (initial parameters, shuffle, dropout). The
model is SparseCTR at the headline's widths with --vocab and --dim,
bf16; the table's adagrad at lr 2.0 with bench.py's compact_cap rule in
fused mode. Prints the card's name and power limit, then one JSON line:
eval_auc, eval_gauc, eval_auc_ceiling, the device metrics' distance
from numpy (metric_err), the AUC against permuted held-out labels
(control_auc), the loss curve, epoch seconds, steady examples/s, step
ms, compact_cap overflow, peak device memory, the run's kernel launches
and the card. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# the device AUC / GAUC against numpy's (chip_smoke.py's METRIC_ATOL)
METRIC_ATOL = 1e-9


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=5_000_000)
    ap.add_argument("--vocab", type=int, default=10_000_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--batch", type=int, default=65_536)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--eval_rows", type=int, default=250_000)
    ap.add_argument("--mode", default="fused")
    ap.add_argument("--rmw", default="split")
    ap.add_argument("--compact_impl", default="xla")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

    import torch

    if not torch.cuda.is_available():
        print("depth_auc: no CUDA device", file=sys.stderr)
        return 2
    from goctr_tpu_torch import bench

    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)
    s = bench.settings([f"--{k}={getattr(args, k)}" for k in (
        "rows", "vocab", "dim", "batch", "epochs", "eval_rows", "mode",
        "rmw", "compact_impl")])
    run = bench.train(s, s.draw(), dev, seed=args.seed)
    line = {**bench.evaluate(run, dev), **run.readings(),
            "card": bench.card_line()}
    print(line["card"], flush=True)
    print(json.dumps(line), flush=True)
    if line["metric_err"] > METRIC_ATOL:
        print(f"depth_auc: device metrics differ from numpy by "
              f"{line['metric_err']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
