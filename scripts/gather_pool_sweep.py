#!/usr/bin/env python3
"""Time the fused gather + pool (K3, csrc/gather_pool.cu) against variants
of its design and against another checkout's kernel, on one NVIDIA card,
on the id streams the main paths give it:

    python3 scripts/gather_pool_sweep.py [--parent DIR]

Streams, made on the card from seed 0 with the port's own functions:
  mesh d<i> s<j>  the first 65,536 rows of chip_smoke's phase 14 (c) (its
                  `make_workload` draw at vocab 1M, in the trainer's
                  shuffled order), cut into 2 data shards of 32,768 rows
                  (data shard i) and masked to model shard j of a 2×2
                  mesh by parallel/embedding.py's own `shard_local_ids`,
                  "sum" on a [500k, 64] shard: each rank's K3 call;
  dense           phase 8's id sets (the first 4 shuffled batches of its
                  `split_workload` draw, 65,536 × 32, no pads) on the
                  [10M, 64] table, "mean", the 1×1 dense path's call.
Each stream is also timed with its real ids alone, compacted to the front
of each row ("real only": the same rows, pads last); the gap between the
two readings is what the empty slots cost a kernel.

Variants, each the committed source with one change, built into its own
library under goctr_tpu_torch/_build/sweep/ (git-ignored), all at once:
  committed             as in the tree (4 batch rows a warp, at most 8
                        lanes a table row: at D = 64 a lane loads 2
                        float4 of each row; unroll 4; 4 warps a block;
                        128-id windows; lists back to back);
  1 row a warp, 32 lanes a row
                        a whole warp a batch row, a table row on up to
                        32 lanes (at D = 64: 2 rows at once);
  2 rows a warp, 32 lanes a row
                        half a warp a batch row (at D = 64 one table row
                        at a time on 16 lanes);
  unroll 2 / unroll 8   kUnroll list entries a slot a round (committed 4);
  8 rows a warp, 4 lanes a row, unroll 2
                        at D = 64 a lane loads 4 float4 of each row;
  lists padded [, unroll 2]
                        a word between two rows' lists, so that the 4
                        rows' list reads fall in different banks;
  32-id windows         a batch row's ids compacted 32 at a time;
  8 warps a block       kWarpsPerBlock = 8 (committed: 4);
  5 blocks an SM asked  __launch_bounds__ with a count of 5 blocks an SM
                        (at most 48 registers a thread);
  parent                csrc/gather_pool.cu of another checkout (--parent
                        DIR, the commit before a change, unpacked with
                        `git archive`), timed first and last (parent,
                        committed, variants, committed, parent).
Each variant's output is held to the plain version (f32 TOL: atol 1e-6,
rtol 1e-5; NaN positions equal). Every call is read two ways: by the
profiler (`device ms`: chip_smoke's `device_ms`, the kernel's device time,
no host gaps) and by CUDA events around 40 back-to-back calls of the C
entry point (`event ms`). Parent and committed are also read as PR 13's
mesh rows were, by events around 20 calls of the port's wrapper
`fused_gather_pool` (`wrapper event ms`: ctypes, the checks, torch.empty
and the launch count included). On the mesh streams the masking glue
before K3 (`shard_local_ids` over the data shard's 1M ids) is timed both
ways too. Prints one JSON line a stream, input and variant: times, batch
rows, real ids and their share, bound (bytes: ids and output once, each
distinct real row once) and share of the bound by device time; then the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from gather_run_sweep import event_ms, sources  # noqa: E402
from goctr_tpu_torch.ops.kernels import _build  # noqa: E402
from goctr_tpu_torch.ops.kernels import embedding_lookup as k3  # noqa: E402
from goctr_tpu_torch.parallel.embedding import shard_local_ids  # noqa: E402


def _set(name: str, value: int):
    """A substitution that sets `constexpr int <name>` to value."""
    return (rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};")


def variants() -> dict[str, list]:
    """{name: substitutions into the committed source}."""
    pad = (r"(lists\[kWarpsPerBlock\]\[kRowsPerWarp\]\[kWindow)\]",
           r"\1 + 1]")
    return {
        "committed": [],
        "1 row a warp, 32 lanes a row": [_set("kRowsPerWarp", 1),
                                         _set("kLanesPerRow", 32)],
        "2 rows a warp, 32 lanes a row": [_set("kRowsPerWarp", 2),
                                          _set("kLanesPerRow", 32)],
        "8 rows a warp, 4 lanes a row, unroll 2": [
            _set("kRowsPerWarp", 8), _set("kLanesPerRow", 4),
            _set("kLaneFloats", 16), _set("kUnroll", 2)],
        "unroll 2": [_set("kUnroll", 2)],
        "unroll 8": [_set("kUnroll", 8)],
        "lists padded": [pad],
        "lists padded, unroll 2": [pad, _set("kUnroll", 2)],
        "32-id windows": [_set("kWindow", 32)],
        "8 warps a block": [_set("kWarpsPerBlock", 8)],
        "5 blocks an SM asked": [_bounds(5)],
    }


def _bounds(blocks: int):
    return (r"__launch_bounds__\(kWarpsPerBlock \* 32\)",
            f"__launch_bounds__(kWarpsPerBlock * 32, {blocks})")


BATCH = chip_smoke.TRAIN_BATCH
MESH_TABLE = 500_000
ATOL, RTOL = 1e-6, 1e-5
_ARGS = k3._ARGTYPES["gather_pool_f32"]


def build_all(parent: Path | None) -> dict[str, Path]:
    """Every variant's library, built in parallel: {variant: path}."""
    base = _build.BUILD_DIR / "sweep"
    jobs = {v: sources(_build.CSRC, "gather_pool", subs,
                       base / re.sub(r"\W+", "_", f"gather_pool_{v}"))
            for v, subs in variants().items()}
    if parent is not None:
        jobs["parent"] = sources(parent / "goctr_tpu_torch" / "csrc",
                                 "gather_pool", [],
                                 base / "gather_pool_parent")
    procs = {v: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
         str(src.with_suffix(".so")), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for v, src in jobs.items()}
    libs = {}
    for v, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"gather_pool {v}: build failed\n{log}")
        libs[v] = jobs[v].with_suffix(".so")
        # each instance: VEC, CH, mean → registers, spill stores
        inst = re.findall(
            r"gather_pool_kernelILi(\d+)ELi(\d+)ELb([01])E.*?(\d+) bytes "
            r"spill stores.*?Used (\d+) registers", log, re.S)
        print(f"[build] gather_pool {v}: " + ", ".join(
            f"{vec}x{ch}{' mean' if m == '1' else ''} {r} regs"
            + (f" {sp} B spilled" if sp != "0" else "")
            for vec, ch, m, sp, r in inst), flush=True)
    return libs


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.gather_pool_f32.argtypes = _ARGS
    lib.gather_pool_f32.restype = ctypes.c_int
    lib.gather_pool_error_string.argtypes = [ctypes.c_int]
    lib.gather_pool_error_string.restype = ctypes.c_char_p
    return lib


def streams(dev, gen) -> dict:
    """{name: (table, [ids, ...], combiner, glue)}: glue is (the data
    shard's ids, model shard, rows a shard) for the mesh streams."""
    hl = chip_smoke.HEADLINE
    t, u, c = hl["behavior_len"], hl["u_profile_dim"], hl["ctx_dim"]
    out = {}
    # phase 14 (c): 3 steps of 65,536 rows at vocab 1M, shuffled as the
    # trainer shuffles (np.random.default_rng(seed).permutation)
    rows = chip_smoke.MESH_RANKS_STEPS * BATCH
    sample = chip_smoke.make_workload(rows, chip_smoke.MESH_RANKS_DENSE_VOCAB,
                                      t, u, c, seed=chip_smoke.SEED)[0]
    order = np.random.default_rng(chip_smoke.SEED).permutation(rows)[:BATCH]
    first = torch.from_numpy(np.ascontiguousarray(
        sample.behavior_ids[order])).to(dev)
    table = torch.randn((MESH_TABLE, hl["emb_dim"]), generator=gen,
                        device=dev).mul_(0.01)
    half = BATCH // 2
    for d in range(2):
        shard_ids = first[d * half:(d + 1) * half].contiguous()
        for s in range(2):
            out[f"mesh d{d} s{s}"] = (
                table, [shard_local_ids(shard_ids, s, MESH_TABLE)], "sum",
                (shard_ids, s, MESH_TABLE))
    # phase 8: the first 4 shuffled batches of its draw, [10M, 64], mean
    v = hl["item_vocab"]
    sample = chip_smoke.split_workload(chip_smoke.TRAIN_ROWS, v, t, u, c,
                                       seed=chip_smoke.SEED)[0]
    order = np.random.default_rng(chip_smoke.SEED).permutation(sample.rows)
    sets = [torch.from_numpy(np.ascontiguousarray(sample.behavior_ids[
        order[b * BATCH:(b + 1) * BATCH]])).to(dev) for b in range(4)]
    dense = torch.randn((v, hl["emb_dim"]), generator=gen,
                        device=dev).mul_(0.01)
    out["dense"] = (dense, sets, "mean", None)
    return out


def real_first(ids: torch.Tensor) -> torch.Tensor:
    """The same rows with their real ids first, in order, pads last."""
    order = torch.argsort((ids < 0).to(torch.int8), dim=1, stable=True)
    return torch.gather(ids, 1, order).contiguous()


def bound_ms(table, id_sets) -> float:
    d = table.shape[1]
    nbytes = np.mean([x.numel() * 4 + x.shape[0] * d * 4
                      + torch.unique(x[x >= 0]).numel() * d * 4
                      for x in id_sets])
    return chip_smoke.bound(nbytes, id_sets[0].numel() * d)[0]


def wrapper_ms(lib, table, id_sets, combiner) -> float:
    """Events around 20 calls of the port's wrapper with `lib` as its
    library (PR 13's reading of the mesh rows)."""
    saved = _build._libs.get(k3._NAME)
    _build._libs[k3._NAME] = lib
    try:
        it = iter(range(1 << 30))
        return chip_smoke.cuda_ms(torch, lambda: k3.fused_gather_pool(
            table, id_sets[next(it) % len(id_sets)], combiner))
    finally:
        if saved is None:
            _build._libs.pop(k3._NAME, None)
        else:
            _build._libs[k3._NAME] = saved


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout's root, timed as 'parent'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gather_pool_sweep: needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)
    libs = {v: load(p) for v, p in build_all(args.parent).items()}
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    inputs = streams(dev, gen)
    names = list(variants())
    order = ["committed", *names[1:], "committed"]
    if args.parent is not None:
        order = ["parent", *order, "parent"]
    for name, (table, id_sets, combiner, glue) in inputs.items():
        v, d = table.shape
        mean = int(combiner == "mean")
        if glue is not None:
            shard_ids, s, per = glue
            byk = []
            glue_dev = chip_smoke.device_ms(
                torch, lambda i: shard_local_ids(shard_ids, s, per), 1,
                by_kernel=byk)
            print(json.dumps({
                "stream": name, "input": "masking glue",
                "ids": shard_ids.numel(), "device_ms": glue_dev,
                "kernels": len(byk),
                "event_ms": event_ms(lambda: shard_local_ids(
                    shard_ids, s, per))}), flush=True)
        for what, sets in (("stream", id_sets),
                           ("real only", [real_first(x) for x in id_sets])):
            n_real = float(np.mean([int((x >= 0).sum()) for x in sets]))
            b, k = sets[0].shape
            bnd = bound_ms(table, sets)
            wants = [k3.fused_gather_pool_plain(table, x, combiner)
                     for x in sets]
            runs = order if what == "stream" else [
                o for o in ("parent", "committed", "committed", "parent")
                if o in libs]
            for var in runs:
                fn = libs[var].gather_pool_f32
                outs = [torch.empty((b, d), device=dev) for _ in sets]

                def call(i, fn=fn, outs=outs):
                    code = fn(table.data_ptr(), sets[i].data_ptr(),
                              outs[i].data_ptr(), b, k, v, d, mean, None, 1,
                              stream)
                    if code:
                        raise RuntimeError(f"{name} {var}: launch failed "
                                           f"{code}")

                for i in range(len(sets)):
                    call(i)
                torch.cuda.synchronize()
                for i, want in enumerate(wants):
                    got = outs[i]
                    assert torch.equal(torch.isnan(got), torch.isnan(want)), (
                        name, what, var)
                    torch.testing.assert_close(
                        torch.nan_to_num(got), torch.nan_to_num(want),
                        atol=ATOL, rtol=RTOL, msg=f"{name} {what} {var}")
                byk = []
                dev_ms = chip_smoke.device_ms(torch, call, len(sets),
                                              iters=8 * len(sets),
                                              by_kernel=byk)
                it = iter(range(1 << 30))
                ev = event_ms(lambda: call(next(it) % len(sets)))
                row = {"stream": name, "input": what, "variant": var,
                       "device_ms": dev_ms, "event_ms": ev,
                       "kernels": len(byk), "rows": b, "k": k,
                       "real": n_real, "real_share": n_real / (b * k),
                       "bound_ms": bnd, "share_of_bound": bnd / dev_ms}
                if what == "stream" and var in ("parent", "committed"):
                    row["wrapper_event_ms"] = wrapper_ms(libs[var], table,
                                                         sets, combiner)
                print(json.dumps(row), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
