"""Dry-run entry points of the port (port of __graft_entry__.py).

entry()               — the flagship DIN ranker's forward and its inputs
                        on the device (a compile-and-run check of one card).
dryrun_multichip(n)   — one real SparseCTR train step on each (data,
                        model) topology of n ranks (the dense step, and the
                        sparse step on grouped lines and on packed rows),
                        held to the 1×1 run of the same start.

    python -m goctr_tpu_torch.dryrun --ranks=4 --device=cpu   (gloo ranks)
    python -m goctr_tpu_torch.dryrun --ranks=2                (NCCL, 2 cards)
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from goctr_tpu_torch.core.meshes import (
    MODEL_AXIS, MeshSpec, launch, make_mesh, single_device_mesh,
)

# vocab 128 divides every model-axis size below (and G = 14 lines pad it
# alike), B = 16 every data-axis size
MODEL = dict(item_vocab=128, emb_dim=8, u_profile_dim=4, ctx_dim=2,
             behavior_len=4, hidden=(16, 8))
PACKED_DIM = 64                 # one row a 128-lane line (G = 1)
BATCH = 16
LOSS_ATOL = 1e-5


def entry(device: str | torch.device = "cuda"):
    """(fwd, (params, x)): the DIN ranker's forward at the reference's
    MovieLens-like widths and 256 rows of inputs, on `device`."""
    from goctr_tpu_torch.core.dtypes import resolve_device
    from goctr_tpu_torch.models import DIN, SampleInfo, split_blocks

    dev = resolve_device(device)
    u, t, d, i, c = 8, 10, 16, 16, 4      # reference MovieLens-ish dims
    w = u + t * d + i + c
    info = SampleInfo((0, u), (u, u + t * d), (u + t * d, u + t * d + i),
                      (u + t * d + i, w))
    model = DIN(u, t, d, i, c)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))

    def fwd(params, x):
        blocks = split_blocks(x, info, t)
        return torch.sigmoid(model.apply(params, blocks, train=False))

    x = torch.from_numpy(np.random.default_rng(0).random(
        (256, w)).astype(np.float32)).to(dev)
    return fwd, (params, x)


def _host_batch() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    t, v = MODEL["behavior_len"], MODEL["item_vocab"]
    return dict(
        user_profile=rng.random((BATCH, 4)).astype(np.float32),
        behavior_ids=rng.integers(0, v, (BATCH, t)).astype(np.int32),
        item_ids=rng.integers(0, v, BATCH).astype(np.int32),
        ctx=rng.random((BATCH, 2)).astype(np.float32),
        labels=(rng.random(BATCH) > 0.5).astype(np.float32))


def topology_losses(mesh) -> dict:
    """One dense step (adam 1e-3 on every leaf, the table included) and
    one sparse step (table adagrad lr 0.05, fused) on grouped lines (D =
    8, G = 14) and on packed rows (D = 64), each from seed 0's start, on
    this rank's shards of `mesh`: the global losses, the overflow counts
    and this rank's global row range."""
    from goctr_tpu_torch.ops.kernels.row_optimizer import (
        group_size, pack_table_grouped)
    from goctr_tpu_torch.optim.optimizers import make_solver
    from goctr_tpu_torch.parallel.sparse_ctr import SparseBatch, SparseCTR
    from goctr_tpu_torch.parallel.table_opt import TableOptConfig
    from goctr_tpu_torch.parallel.train import (
        dense_path_leaves, local_batch, make_sharded_sparse_train_step,
        make_sharded_train_step)

    dev = mesh.device
    batch = local_batch(SparseBatch(**{
        k: torch.from_numpy(v).to(dev) for k, v in _host_batch().items()}),
        mesh)
    solver = make_solver("adam", 1e-3)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    model = SparseCTR(**MODEL, device=dev)
    table = model.init_params(gen(0), mesh)
    state = solver.init(dense_path_leaves(model, table))
    step = make_sharded_train_step(model, solver, mesh)
    loss, _ = step(table, state, batch, gen(1))
    j = mesh.index(MODEL_AXIS)
    out = {"dense": float(loss),
           "rows": (j * table.shape[0], (j + 1) * table.shape[0])}
    for name, dim in (("grouped", MODEL["emb_dim"]), ("packed", PACKED_DIM)):
        model = SparseCTR(**dict(MODEL, emb_dim=dim), device=dev)
        g = group_size(dim)
        w = model.init_params(gen(0), mesh, row_multiple=g)
        table = pack_table_grouped(w)
        state = solver.init(model.param_leaves())
        step = make_sharded_sparse_train_step(
            model, solver, mesh, TableOptConfig(kind="adagrad", lr=0.05))
        with torch.no_grad():
            loss, _, over = step(table, state, None, batch, gen(1))
        out[name] = float(loss)
        out[f"{name}_overflow"] = int(over)
    return out


def _rank_losses(specs: list[tuple[int, int]], devices: list[str]
                 ) -> list[dict]:
    """topology_losses on each (d, m) mesh of the launched ranks, in
    order."""
    return [topology_losses(make_mesh(MeshSpec(*s), devices=devices))
            for s in specs]


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: str | None = None) -> dict:
    """Sweep (n, 1), (n/2, 2) and (n/4, 4) over n ranks and assert that
    every rank's dense, grouped and packed step losses match the 1×1 run
    on `device` within LOSS_ATOL, that no id overflowed, and that the
    table is row-distributed (m distinct row ranges). The ranks run on
    "cpu" over gloo, or on the cards over NCCL (rank r on card r; pass
    backend="gloo" to let ranks share cards). Returns the losses by
    topology."""
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        devices = [f"cuda:{r % max(count, 1)}" for r in range(n_devices)]
    else:
        devices = ["cpu"] * n_devices
    single = topology_losses(single_device_mesh(devices[0]))
    found = {"1x1": single}
    topologies = [(n_devices, 1)] + [(n_devices // m, m) for m in (2, 4)
                                     if n_devices % m == 0]
    by_rank = launch(_rank_losses, n_devices, devices, backend,
                     args=(topologies, devices))
    for i, (d, m) in enumerate(topologies):
        ranks = [got[i] for got in by_rank]
        for name in ("dense", "grouped", "packed"):
            for r, got in enumerate(ranks):
                if abs(got[name] - single[name]) >= LOSS_ATOL:
                    raise AssertionError(
                        f"{name} loss parity broken on (data={d}, model={m})"
                        f" rank {r}: {got[name]} vs 1x1 {single[name]}")
        if any(got["grouped_overflow"] or got["packed_overflow"]
               for got in ranks):
            raise AssertionError(f"ids overflowed on (data={d}, model={m})")
        row_ranges = {got["rows"] for got in ranks}
        if len(row_ranges) != m:
            raise AssertionError(f"table not row-distributed: "
                                 f"{len(row_ranges)} distinct ranges on "
                                 f"model={m}")
        found[f"{d}x{m}"] = ranks[0]
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    a = ap.parse_args(argv)
    for topo, losses in dryrun_multichip(a.ranks, a.device,
                                         a.backend).items():
        print(topo, {k: losses[k] for k in ("dense", "grouped", "packed")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
