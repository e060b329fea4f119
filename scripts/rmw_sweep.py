#!/usr/bin/env python3
"""Time the one-pass row update (K5 `row_rmw`, K6 `line_rmw`,
csrc/row_rmw.cu) against variants of its design and against another
checkout's kernel, on one NVIDIA card, on the streams the main paths give
it:

    python3 scripts/rmw_sweep.py [--parent DIR]

Streams, made on the card from seed 0 with the port's own functions,
from the first 65,536 rows of chip_smoke's bench workload (its
`make_workload`), N(0, 0.01²) gradient rows, adagrad, lr 2.0:
  K5 headline    the scanned trainer's update of the 10M × 64 packed rows:
                 the batch's ids sorted and compacted with the bench cap
                 (`update_rows`, compact_impl "xla");
  K6 grouped     the same for the 100M × 16 lines (G = 7), then
                 `line_stream`;
  K5 mesh 2x2 s  stage 4 of parallel/train.py for model shard s of a 2×2
                 mesh, made in one process by its own functions: each
                 data shard's half of the batch compacted
                 (`compact_stream`, stage 1), the two streams concatenated
                 (in place of stage 2's all_gather), merged by id and
                 masked to the shard (`shard_stream`, stages 3 and 4);
  K6 mesh 1x2 s  the same for the 100M × 16 lines on a 1×2 mesh.
Each stream is also timed, for the committed source and the parent, with
its real slots alone ("real only": the ids and update rows of the real
slots, the same work without the slots the kernel skips; the gap is what
the skipped slots cost a kernel), with those in a random order ("real
only, shuffled": whether the order of the update rows matters) and
under sgd ("stream, sgd": fewer instructions a row).

Variants, each the committed source with one change, built into its own
library under goctr_tpu_torch/_build/sweep/ (git-ignored), all at once:
  committed          as in the tree;
  profiled           the committed source with a globaltimer reading at
                     each warp's start and end (see `warp_times`);
  4 rows             kRowsInFlight real rows a round (committed: 2),
                     without the 4 blocks an SM;
  no blocks asked    __launch_bounds__ without a count of blocks an SM
                     (committed: 4, at most 64 registers a thread);
  ldcs updates       update rows read evict-first (__ldcs; committed:
                     __ldg, through the read-only cache);
  1-chunk / 8-chunk tiles
                     kChunks 32-slot chunks a warp loads a tile (a block
                     tile of 8 warps: 256 or 2,048 slots; committed: 4,
                     1,024 slots);
  parent             csrc/row_rmw.cu of another checkout (--parent DIR,
                     the commit before a change, unpacked with `git
                     archive`), timed first and last (parent, committed,
                     variants, committed, parent);
  parent profiled    the parent with the same globaltimer readings.
Each variant's touched lines after one call are held to the plain
arithmetic (`rmw_lines` on the lines as they were; rtol 1e-6, atol 1e-7:
rsqrtf against torch.rsqrt). Prints one JSON line a stream and variant:
ms a call (CUDA events over 40 calls after 5), slots, real slots, bound
(bytes: the ids, and the live 32-byte sectors of each real line read and
written and of its update row read) and share of the bound; then the
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
from goctr_tpu_torch.ops.kernels import row_optimizer as ro  # noqa: E402
from goctr_tpu_torch.parallel import scanned as sc  # noqa: E402
from goctr_tpu_torch.parallel.table_opt import TableOptConfig  # noqa: E402
from goctr_tpu_torch.parallel.train import (  # noqa: E402
    compact_stream, shard_stream)

# a globaltimer reading at each warp's start and end and its count of real
# rows (the committed kernel: its block's lists' lengths summed; the
# parent: its own of 4 slots), kept for the first PROF_WARPS warps of the
# grid; row_rmw_prof copies them out and zeroes them
PROF_WARPS = 1 << 20
_TIMER = '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"({}));\n'


def _profiled(begin: str, rows_at: str, end: str, rows_end: str,
              warp: str) -> list:
    """Substitutions that add the readings: after the match of `begin`,
    before that of `rows_at` (n_rows += count) and after that of `end`
    (rows_end, then the store; `warp` is the warp's index in the grid)."""
    subs = [
        (r"(namespace \{\n)",
         f"__device__ unsigned long long g_prof[3 * {PROF_WARPS}];\n\\1"),
        (begin, "\\1  unsigned long long t_begin;\n" + _TIMER.format("t_begin")
         + "  unsigned long long n_rows = 0;\n"),
        (end, "\\1" + rows_end + "  unsigned long long t_end;\n"
         + _TIMER.format("t_end") + f"  const long long gw = {warp};\n"
         f"  if ((threadIdx.x & 31) == 0 && gw < {PROF_WARPS}) {{\n"
         "    g_prof[3 * gw] = t_begin;\n    g_prof[3 * gw + 1] = t_end;\n"
         "    g_prof[3 * gw + 2] = n_rows;\n  }\n"),
        (r'(extern "C" const char\* row_rmw_error_string)',
         'extern "C" int row_rmw_prof(void* out) {\n'
         '  void* p = nullptr;\n'
         '  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n'
         '  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, g_prof);\n'
         '  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_prof));\n'
         '  return (int)e;\n'
         '}\n\n\\1'),
    ]
    if rows_at:
        subs.append((rows_at, "    n_rows += count;\n\\1"))
    return subs


PROFILED = _profiled(
    r"(  __shared__ BlockSmem sm;\n)",
    r"(    // the warps take the list's entries)",
    r"(      rows = ahead;\n    \}\n  \}\n)", "",
    "blockIdx.x + static_cast<long long>(gridDim.x) * (threadIdx.x / 32)")
# the parent: a warp takes 4 slots; n_rows counts the real ones
PROFILED_PARENT = _profiled(
    r"(float lr, float eps\) \{\n)", "",
    r"(          make_float4\(out\[0\], out\[1\], out\[2\], out\[3\]\);"
    r"\n  \}\n)",
    "  for (int i = 0; i < kRowsPerWarp; ++i) n_rows += id[i] >= 0;\n",
    "static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32")
# the kernel's __launch_bounds__ without its 4 blocks an SM (64 registers
# a thread, which 4 rows a round would spill past)
NO_BLOCKS_ASKED = (r"__launch_bounds__\(kWarpsPerBlock \* 32, 4\)",
                   "__launch_bounds__(kWarpsPerBlock * 32)")
VARIANTS = {
    "committed": [],
    "profiled": PROFILED,
    "4 rows": [(r"constexpr int kRowsInFlight = \d+;",
                "constexpr int kRowsInFlight = 4;"), NO_BLOCKS_ASKED],
    "no blocks asked": [NO_BLOCKS_ASKED],
    "ldcs updates": [(r"(rows\.u\[i\] = )__ldg\(", "\\1__ldcs(")],
    "1-chunk tiles": [(r"constexpr int kChunks = \d+;",
                       "constexpr int kChunks = 1;")],
    "8-chunk tiles": [(r"constexpr int kChunks = \d+;",
                       "constexpr int kChunks = 8;")],
}
BATCH = 65_536
LR, EPS = 2.0, 1e-8


def build_all(parent: Path | None) -> dict[str, Path]:
    """Every variant's library, built in parallel: {variant: path}."""
    base = _build.BUILD_DIR / "sweep"
    jobs = {v: sources(_build.CSRC, "row_rmw", subs,
                       base / re.sub(r"\W+", "_", f"row_rmw_{v}"))
            for v, subs in VARIANTS.items()}
    if parent is not None:
        for v, subs in (("parent", []), ("parent profiled", PROFILED_PARENT)):
            jobs[v] = sources(parent / "goctr_tpu_torch" / "csrc", "row_rmw",
                              subs, base / re.sub(r"\W+", "_", f"row_rmw_{v}"))
    procs = {v: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
         str(src.with_suffix(".so")), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for v, src in jobs.items()}
    libs = {}
    for v, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"row_rmw {v}: build failed\n{log}")
        libs[v] = jobs[v].with_suffix(".so")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"[build] row_rmw {v}: registers {regs}, spill stores "
              f"{spills}", flush=True)
    return libs


def batch_ids(sample, rows: slice):
    """[behaviors; items] ids of `rows` of the sample, as the trainers
    flatten them."""
    return torch.cat([torch.from_numpy(sample.behavior_ids[rows]).reshape(-1),
                      torch.from_numpy(sample.item_ids[rows])])


def stage4_stream(ids_by_shard, grads_by_shard, per_shard: int, m: int,
                  shard: int, group: int):
    """Model shard `shard` of m's stage-4 stream, by parallel/train.py's
    own stages (stage 2's all_gather over the data shards is their
    concatenation). Returns (ids [n] int32, update rows [n, 128] f32,
    skip_ge)."""
    v = per_shard * m
    parts = [compact_stream(ids, grads, v, None)
             for ids, grads in zip(ids_by_shard, grads_by_shard)]
    return shard_stream(torch.cat([p[0] for p in parts]),
                        torch.cat([p[1] for p in parts]), v, per_shard,
                        shard, group, packed=True)


def streams(dev, gen):
    """{name: (table, ids, update rows, skip_ge, d, group)} for the
    headline, grouped and mesh streams."""
    out = {}
    for cfg, key in ((chip_smoke.HEADLINE, "K5"), (chip_smoke.GROUPED, "K6")):
        vocab, d = cfg["item_vocab"], cfg["emb_dim"]
        group = ro.group_size(d) if key == "K6" else 1
        sample = chip_smoke.make_workload(BATCH, vocab, cfg["behavior_len"],
                                          cfg["u_profile_dim"],
                                          cfg["ctx_dim"], seed=0)[0]
        ids = batch_ids(sample, slice(None)).to(dev)
        grads = torch.randn(ids.numel(), d, generator=gen, device=dev) * 0.01
        rows = ro.packed_lines(vocab, d) if group > 1 else vocab
        table = torch.randn(rows, 128, generator=gen, device=dev) * 0.01
        for grp in range(group):
            table[:, grp * (d + 1) + d] = torch.rand(rows, generator=gen,
                                                     device=dev)
        topt = TableOptConfig(kind="adagrad", lr=LR, update_mode="fused",
                              compact_cap=chip_smoke.bench_compact_cap(
                                  sample, BATCH))
        tgt, r, _, _ = sc.update_rows(ids, grads, topt, vocab)
        if group > 1:
            tgt, upd = sc.line_stream(tgt, r, vocab)
        else:
            upd = ro.pack_grads(r)
        out[f"{key} {'grouped' if group > 1 else 'headline'}"] = (
            table, tgt, upd, rows, d, group)
        # the mesh: (a) 2×2 for the packed rows, (b) 1×2 for the lines
        n_data = 2 if group == 1 else 1
        half = BATCH // n_data
        by_shard = [batch_ids(sample, slice(k * half, (k + 1) * half)).to(dev)
                    for k in range(n_data)]
        g_shard = [torch.randn(x.numel(), d, generator=gen, device=dev) * 0.01
                   for x in by_shard]
        shard_rows = -(-rows // 2)
        for s in range(2):
            lid, lupd, skip = stage4_stream(by_shard, g_shard,
                                            shard_rows * group, 2, s, group)
            spec = "2x2" if group == 1 else "1x2"
            out[f"{key} mesh {spec} shard {s}"] = (
                table[:shard_rows], lid, lupd, skip, d, group)
    return out


def warp_times(lib, call) -> dict:
    """The profiled build's warps in one call, in µs after the first
    began: when they ended (percentiles and the last), the share of the
    span a warp ran, and the warps alive over the span (a count that
    rises at each start and falls at each end): its peak, its mean as a
    share of the peak, the ramp (until half the peak is first alive) and
    the tail (from when fewer than half are alive for the last time to
    the end). Also the real rows of the warps that ended last against the
    median warp's."""
    buf = (ctypes.c_ulonglong * (3 * PROF_WARPS))()
    lib.row_rmw_prof(buf)                       # zeroes the readings
    call()
    torch.cuda.synchronize()
    if lib.row_rmw_prof(buf):
        raise RuntimeError("row_rmw_prof failed")
    a = np.frombuffer(buf, dtype=np.uint64).reshape(-1, 3).astype(np.float64)
    a = a[a[:, 0] > 0]
    t0 = a[:, 0].min()
    begin, end = (a[:, 0] - t0) / 1e3, (a[:, 1] - t0) / 1e3
    span = float(end.max())
    t = np.concatenate([begin, end])
    o = np.argsort(t, kind="stable")
    t = t[o]
    alive = np.cumsum(np.concatenate([np.ones_like(begin),
                                      -np.ones_like(end)])[o])
    held = np.diff(t, append=span)              # how long each count held
    peak = float(alive.max())
    up = np.nonzero(alive >= peak / 2)[0]
    late = end >= np.quantile(end, 0.99)
    return {"warps": int(a.shape[0]),
            "warp_end_us": {q: float(np.quantile(end, float(q)))
                            for q in ("0.1", "0.5", "0.9", "0.99")},
            "last_end_us": span,
            "warp_busy_share": float((end - begin).mean() / span),
            "alive_peak": peak,
            "alive_mean_share": float((alive * held).sum() / span / peak),
            "ramp_us": float(t[up[0]]),
            "tail_us": float(span - t[min(up[-1] + 1, t.size - 1)]),
            "rows_of_last_1pct": float(a[late, 2].mean()),
            "rows_median": float(np.median(a[:, 2]))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout's root, timed as 'parent'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rmw_sweep: needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)
    libs = build_all(args.parent)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = streams(dev, gen)
    order = ["committed", *[v for v in VARIANTS if v != "committed"],
             "committed"]
    if args.parent is not None:
        order = ["parent", "parent profiled", *order, "parent"]
    fns = {}
    for v, path in libs.items():
        lib = ctypes.CDLL(str(path))
        fns[v] = {}
        for entry in ("row_rmw", "line_rmw"):
            fn = getattr(lib, entry)
            fn.argtypes = ro._RMW_ARGTYPES[entry]
            fn.restype = ctypes.c_int
            fns[v][entry] = fn
        fns[v]["lib"] = lib
    for name, (table, ids, upd, skip, d, group) in inputs.items():
        real = (ids >= 0) & (ids < skip)
        n_real = int(real.sum())
        hit = ids[real].long()
        live = -(-4 * group * (d + 1) // 32) * 32
        shuffled = torch.randperm(n_real, generator=gen, device=dev)
        for what, x, u, kind in (
                ("stream", ids, upd, "adagrad"),
                ("real only", ids[real].contiguous(), upd[real].contiguous(),
                 "adagrad"),
                ("real only, shuffled", ids[real][shuffled].contiguous(),
                 upd[real][shuffled].contiguous(), "adagrad"),
                ("stream, sgd", ids, upd, "sgd")):
            nbytes = x.numel() * 4 + n_real * live * 3
            bound_ms = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
            for v in (order if what == "stream" else
                      [o for o in ("parent", "committed") if o in libs]):
                fn = fns[v]["line_rmw" if group > 1 else "row_rmw"]

                def call():
                    code = fn(table.data_ptr(), x.data_ptr(), u.data_ptr(),
                              x.numel(), skip, d, int(kind == "adagrad"), LR,
                              EPS, stream)
                    if code:
                        raise RuntimeError(f"{name} {v}: launch failed "
                                           f"{code}")

                before = table[hit]
                call()
                want = ro.rmw_lines(before, upd[real], LR, d, kind, EPS,
                                    group)
                torch.testing.assert_close(table[hit], want, rtol=1e-6,
                                           atol=1e-7,
                                           msg=f"{name} {what} {v}")
                del before, want
                ms = event_ms(call)
                row = {"stream": name, "input": what, "variant": v, "ms": ms,
                       "slots": x.numel(), "real": n_real,
                       "real_share": n_real / ids.numel(),
                       "bound_ms": bound_ms, "share_of_bound": bound_ms / ms}
                if v.endswith("profiled"):
                    row.update(warp_times(fns[v]["lib"], call))
                print(json.dumps(row), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
