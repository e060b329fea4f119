"""Scaling measurement: SparseCTR's dense train step (adam on every leaf,
the row-sharded table included) in examples/s over 1, 2, 4 and 8 ranks
(port of examples/scaling.py). Each topology is (n/m, m) with m = 2 model
shards from 2 ranks on, 4096 rows a data shard, a 1M × 16 table.

    python -m goctr_tpu_torch.examples.scaling              # cards, NCCL
    python -m goctr_tpu_torch.examples.scaling --cpu        # gloo ranks
    python -m goctr_tpu_torch.examples.scaling --ranks=1,2 --backend=gloo
        (ranks beyond the card count share cards; the collectives go
         through the host, so this measures the staging, not scaling)

On the CPU it exercises the ranks' collectives and the scaling shape, not
the card's speed. Each line names the device (and on a card its power
limit); ranks run as spawned processes (core/meshes.py `launch`).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from goctr_tpu_torch.core.meshes import (
    MeshSpec, launch, make_mesh, single_device_mesh,
)


def measure(mesh, batch_per_device: int = 4096, vocab: int = 1_000_000,
            steps: int = 20) -> float:
    """examples/s of the dense step on this rank's shards of `mesh` (the
    same number on every rank: the slowest rank's pace)."""
    from goctr_tpu_torch.optim.optimizers import make_solver
    from goctr_tpu_torch.parallel.sparse_ctr import SparseBatch, SparseCTR
    from goctr_tpu_torch.parallel.train import (
        dense_path_leaves, local_batch, make_sharded_train_step)

    dev = mesh.device
    model = SparseCTR(item_vocab=vocab, emb_dim=16, u_profile_dim=8,
                      ctx_dim=4, behavior_len=10, hidden=(200, 80),
                      device=dev)
    table = model.init_params(torch.Generator(device=dev).manual_seed(0),
                              mesh)
    solver = make_solver("adam", 1e-3)
    state = solver.init(dense_path_leaves(model, table))
    step = make_sharded_train_step(model, solver, mesh)
    b = batch_per_device * mesh.data
    rng = np.random.default_rng(0)
    host = dict(user_profile=rng.random((b, 8)).astype(np.float32),
                behavior_ids=rng.integers(0, vocab, (b, 10)).astype(np.int32),
                item_ids=rng.integers(0, vocab, b).astype(np.int32),
                ctx=rng.random((b, 4)).astype(np.float32),
                labels=(rng.random(b) > 0.5).astype(np.float32))
    batch = local_batch(SparseBatch(**{
        k: torch.from_numpy(v).to(dev) for k, v in host.items()}), mesh)
    loss, state = step(table, state, batch)          # warm-up
    float(loss)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss, state = step(table, state, batch)
    float(loss)                     # the global loss: every rank waits
    return steps * b / (time.perf_counter() - t0)


def _rank_measure(spec, devices) -> float:
    return measure(make_mesh(MeshSpec(*spec), devices=devices))


def device_line(cpu: bool) -> str:
    if cpu:
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--ranks", default="1,2,4,8")
    ap.add_argument("--backend", default=None,
                    help="nccl (cards) or gloo; default: nccl on cards, "
                         "gloo with --cpu")
    a = ap.parse_args(argv)
    backend = a.backend or ("gloo" if a.cpu else "nccl")
    if a.cpu:
        avail = 8
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no card: pass --cpu to run gloo ranks")
        avail = (torch.cuda.device_count() if backend == "nccl" else 8)
    print(f"device={device_line(a.cpu)} backend={backend}")
    print(f"{'ranks':>6} {'mesh':>6} {'examples/s':>14} {'scale':>7}")
    base = None
    for n in (int(x) for x in a.ranks.split(",")):
        if n > avail:
            print(f"{n:>6} not run: {avail} ranks available")
            break
        m = 2 if n >= 2 else 1
        if n == 1:
            eps = measure(single_device_mesh("cpu" if a.cpu else "cuda"))
        else:
            devices = (["cpu"] * n if a.cpu else
                       [f"cuda:{r % torch.cuda.device_count()}"
                        for r in range(n)])
            eps = launch(_rank_measure, n, devices, backend,
                         args=((n // m, m), devices))[0]
        base = base or eps
        print(f"{n:>6} {n // m}x{m:<4} {eps:>14,.1f} {eps / base:>6.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
