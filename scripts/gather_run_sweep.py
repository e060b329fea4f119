#!/usr/bin/env python3
"""Time the row gather (K1, csrc/row_gather.cu) and the sorted-run row
update (K8, csrc/run_rmw.cu) against variants of their design, on one
NVIDIA card, at the main paths' shapes:

    python3 scripts/gather_run_sweep.py [--parent DIR]

Each variant is the committed source with one change, built into its own
library under goctr_tpu_torch/_build/sweep/ (git-ignored); all are built
at once, one nvcc a source. K1's variants:
  committed           as in the tree;
  4 loads / 16 loads  kLoads float4s in flight a lane before its stores
                      (committed: 8);
  plain stores        the output stored without the streaming hint
                      (committed: st.global.cs);
  grouped: elements   grouped rows by element loads and stores instead
                      of the shifted float4 span.
K8's variants:
  committed           as in the tree;
  profiled            the committed source with clock64 timers (the share
                      of the tile pass's warp time spent waiting for the
                      ring, updating lines and in the row flags);
  4 / 16 lines in flight
                      kLinesInFlight line loads a warp issues before it
                      updates the first (committed: 8);
  rows unrolled 1     the row loop not unrolled (committed: 4 times);
  no line loads, no line updates, copies only
                      what the tile pass's parts cost: without the
                      lines' loads, without any line update, and without
                      the row sums too (wrong outputs, not checked).
--parent DIR adds the sources of another checkout of the repository (the
commit before a change, unpacked with `git archive`) as "parent", timed
first and last (parent, committed, variants, committed, parent), so that
a change and its parent are compared within one run on one card.

Inputs, made on the card from seed 0: the headline's first training step
in shape (65,536 rows × (32 behaviors + 1 item) = 2,162,688 zipf s = 1.05
ids over 10M items, hot ranks scattered as the bench workload does): K1
gathers them to bf16 from the packed [10M, 128] table (D = 64) and from
grouped 100M × 16 lines (G = 7), reads the 128 f32 lanes of the batch's
distinct ids, and serves 17,408 ids from the plain [10M, 64] table; K8
updates the packed table from the ids sorted, with N(0, 0.01²) gradient
rows (adagrad, lr 2.0). Every K1 variant is held bit-exact to the plain
version; every K8 variant's lines after one call are held to those of
the first one timed bit for bit (they sum in the same order; the parent
too, where its K8 sums in that order), and its distance from K8's plain
version is printed.
Prints one JSON line a variant: ms per call (CUDA events over 40 calls
after 5; for K8 also the device time of its kernels, torch.profiler over
24 calls); then the card's name and power limit.
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
from goctr_tpu_torch.ops.kernels import _build  # noqa: E402
from goctr_tpu_torch.ops.kernels import row_gather as k1  # noqa: E402
from goctr_tpu_torch.ops.kernels import row_optimizer as ro  # noqa: E402
from goctr_tpu_torch.ops.kernels import run_optimizer as k8  # noqa: E402

K1_VARIANTS = {
    "committed": [],
    "4 loads": [(r"constexpr int kLoads = \d+;",
                 "constexpr int kLoads = 4;")],
    "16 loads": [(r"constexpr int kLoads = \d+;",
                  "constexpr int kLoads = 16;")],
    "plain stores": [(r"constexpr bool kStreamStores = true;",
                      "constexpr bool kStreamStores = false;")],
    "grouped: elements": [(r"group == 1 \? kAligned : kShifted",
                           "group == 1 ? kAligned : kScalar")],
}
# the committed source with clock64 timers: each warp sums the cycles it
# spends in all, waiting for the ring, updating each part's finished runs'
# lines (their loads, updates and stores) and in each part's row flags
# (where a wait for its ids would show), and adds them to k8_prof once;
# run_rmw_prof copies the sums out
PROFILED = [
    (r"namespace \{\n\nusing line_update::Batch;",
     "__device__ unsigned long long k8_prof[4];\nnamespace {\n\n"
     "using line_update::Batch;"),
    (r"  if \(tile >= a\.n_tiles\) return;\n  unsigned char\* base",
     "  if (tile >= a.n_tiles) return;\n  const long long t_all = clock64();\n"
     "  long long t_wait = 0, t_lines = 0, t_flags = 0;\n"
     "  unsigned char* base"),
    (r"const unsigned char\* stage = ring\.wait\(tile, p, in, delta\);",
     "const long long t0 = clock64();\n"
     "    const unsigned char* stage = ring.wait(tile, p, in, delta);\n"
     "    t_wait += clock64() - t0;"),
    (r"    lines\.update\(a, lane\);\n    while \(true\) \{",
     "    const long long t1 = clock64();\n    lines.update(a, lane);\n"
     "    while (true) {"),
    (r"    // the stage is read: refill it",
     "    t_lines += clock64() - t1;\n    // the stage is read: refill it"),
    (r"const RowFlags f = row_flags\(a, tile, ids, p, lane\);\n"
     r"(\s*)const unsigned in = __ballot_sync\(kFull, f\.real\);",
     "const long long t2 = clock64();\n"
     "\\1const RowFlags f = row_flags(a, tile, ids, p, lane);\n"
     "\\1const unsigned in = __ballot_sync(kFull, f.real);\n"
     "\\1t_flags += clock64() - t2;"),
    (r"  if \(lane == 0\) \{\n    a\.tile_pass\[tile\]",
     "  if (lane == 0) {\n"
     "    atomicAdd(&k8_prof[0], (unsigned long long)(clock64() - t_all));\n"
     "    atomicAdd(&k8_prof[1], (unsigned long long)t_wait);\n"
     "    atomicAdd(&k8_prof[2], (unsigned long long)t_lines);\n"
     "    atomicAdd(&k8_prof[3], (unsigned long long)t_flags);\n  }\n"
     "  if (lane == 0) {\n    a.tile_pass[tile]"),
    (r'extern "C" const char\* run_rmw_error_string',
     'extern "C" int run_rmw_prof(void* out) {\n'
     '  return (int)cudaMemcpyFromSymbol(out, k8_prof, sizeof(k8_prof));\n'
     '}\n\nextern "C" const char* run_rmw_error_string'),
]
K8_VARIANTS = {
    "committed": [],
    "profiled": PROFILED,
    "4 lines in flight": [(r"constexpr int kLinesInFlight = \d+;",
                           "constexpr int kLinesInFlight = 4;")],
    "16 lines in flight": [(r"constexpr int kLinesInFlight = \d+;",
                            "constexpr int kLinesInFlight = 16;")],
    "rows unrolled 1": [(r"#pragma unroll 4\n(\s*)for \(int r = 0",
                         "#pragma unroll 1\n\\1for (int r = 0")],
    # what the parts cost (their outputs are wrong, so not checked): the
    # tile pass without the line loads (the updates start from zeros),
    # without line updates, and without the row sums too (the ring's
    # copies and the walk alone)
    "no line loads": [(r"t\[i\] = line_update::load_line\(a\.table, id\[i\], "
                       r"a\.d, lane\);",
                       "t[i] = make_float4(0.f, 0.f, 0.f, 0.f);")],
    "no line updates": [(r"    lines\.update\(a, lane\);\n    while",
                         "    done = 0;\n    lines.update(a, lane);\n"
                         "    while")],
    "copies only": [(r"    lines\.update\(a, lane\);\n    while",
                     "    done = 0;\n    lines.update(a, lane);\n"
                     "    while"),
                    (r"if \(\(in >> r\) & 1u\) load_dims", "if (0) load_dims")],
}

UNCHECKED = {"no line loads", "no line updates", "copies only"}
HEADERS = ("bulk_copy.cuh", "line_update.cuh")
K1_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]
K8_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_int] \
    + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3
BATCH, SEQ, V, V_GROUPED = 65_536, 32, 10_000_000, 100_000_000


def sources(csrc: Path, name: str, subs, out: Path) -> Path:
    """Write csrc/<name>.cu and the headers, with `subs` applied, to out;
    each pattern must match somewhere."""
    out.mkdir(parents=True, exist_ok=True)
    hits = dict.fromkeys(pattern for pattern, _ in subs)
    for src in (f"{name}.cu", *HEADERS):
        if not (csrc / src).exists():
            continue
        text = (csrc / src).read_text()
        for pattern, repl in subs:
            text, n = re.subn(pattern, repl, text)
            hits[pattern] = (hits[pattern] or 0) + n
        (out / src).write_text(text)
    missing = [p for p, n in hits.items() if not n]
    if missing:
        raise RuntimeError(f"{name}: patterns {missing} not found")
    return out / f"{name}.cu"


def build_all(parent: Path | None) -> dict[tuple[str, str], Path]:
    """Every variant's library, built in parallel: {(kernel, variant)}."""
    jobs = {}
    base = _build.BUILD_DIR / "sweep"
    for name, variants in (("row_gather", K1_VARIANTS),
                           ("run_rmw", K8_VARIANTS)):
        for variant, subs in variants.items():
            out = base / re.sub(r"\W+", "_", f"{name}_{variant}")
            jobs[name, variant] = sources(_build.CSRC, name, subs, out)
        if parent is not None:
            jobs[name, "parent"] = sources(
                parent / "goctr_tpu_torch" / "csrc", name, [],
                base / f"{name}_parent")
    procs = {key: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
         str(src.with_suffix(".so")), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for key, src in jobs.items()}
    libs = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{key}: build failed\n{log}")
        libs[key] = jobs[key].with_suffix(".so")
        regs = re.findall(r"Used (\d+) registers", log)
        print(f"[build] {key[0]} {key[1]}: registers {regs}", flush=True)
    return libs


def event_ms(fn, iters=40, warmup=5) -> float:
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


def zipf_ids(rng, shape, vocab) -> np.ndarray:
    """The bench workload's ids: zipf ranks over half the vocabulary,
    scattered by a multiplicative hash, and a random parity bit."""
    half = vocab // 2
    r = chip_smoke._zipf_ranks(rng, shape, half)
    return ((r * 2_654_435_761) % half * 2
            + rng.integers(0, 2, shape)).astype(np.int32)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout's root, timed as 'parent'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gather_run_sweep: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    libs = build_all(args.parent)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    n = BATCH * (SEQ + 1)
    ids = torch.from_numpy(zipf_ids(rng, n, V)).to(dev)
    g_ids = torch.from_numpy(zipf_ids(rng, n, V_GROUPED)).to(dev)
    serve_ids = ids[:17_408].contiguous()
    read_ids = torch.unique(ids).int()
    packed = torch.randn(V, 128, generator=gen, device=dev) * 0.01
    packed[:, 64] = torch.rand(V, generator=gen, device=dev)
    plain = packed[:, :64].contiguous()
    G = ro.group_size(16)
    lines = torch.randn(-(-V_GROUPED // G), 128, generator=gen,
                        device=dev) * 0.01
    # (name, table, ids, group, dim, out dtype)
    k1_shapes = [
        ("forward D=64", packed, ids, 1, 64, torch.bfloat16),
        ("forward grouped D=16", lines, g_ids, G, 16, torch.bfloat16),
        ("row-update read", packed, read_ids, 1, 128, torch.float32),
        ("serving", plain, serve_ids, 1, 64, torch.bfloat16)]
    s_ids = torch.sort(ids).values
    g_rows = torch.randn(n, 64, generator=gen, device=dev) * 0.01
    n_tiles = -(-n // k8.TILE_ROWS)
    n_groups = -(-n_tiles // k8.GROUP_TILES)
    ints = torch.empty(2 * n_tiles + n_groups, dtype=torch.int32, device=dev)
    floats = torch.empty((2 * n_tiles + 2 * n_groups) * 64,
                         dtype=torch.float32, device=dev)
    touched = torch.unique(s_ids).long()
    print(f"[inputs] {n} ids ({read_ids.numel()} distinct), grouped "
          f"{torch.unique(g_ids).numel()} distinct; lines "
          f"{tuple(lines.shape)}", flush=True)

    def k1_row(variant):
        lib = ctypes.CDLL(str(libs["row_gather", variant]))
        row = {"kernel": "K1", "variant": variant}
        for what, table, x, group, dim, dt in k1_shapes:
            fn = lib.row_gather_bf16 if dt == torch.bfloat16 \
                else lib.row_gather_f32
            fn.restype = ctypes.c_int
            fn.argtypes = K1_ARGS
            out = torch.empty(x.numel(), dim, dtype=dt, device=dev)

            def call():
                code = fn(table.data_ptr(), x.data_ptr(), out.data_ptr(),
                          x.numel(), table.shape[0] * group, table.shape[1],
                          group, dim, stream)
                if code:
                    raise RuntimeError(f"K1 {variant}: launch failed {code}")

            call()
            want = k1.gather_rows_plain(table, x, group=group, dim=dim,
                                        out_dtype=dt)
            if not torch.equal(out, want):
                raise RuntimeError(f"K1 {variant} {what}: differs from plain")
            del want
            row[what] = event_ms(call)
        return row

    reference = {}

    def k8_row(variant):
        lib = ctypes.CDLL(str(libs["run_rmw", variant]))
        fn = lib.run_rmw
        fn.restype = ctypes.c_int
        fn.argtypes = K8_ARGS

        def call(table):
            code = fn(table.data_ptr(), s_ids.data_ptr(), g_rows.data_ptr(),
                      n, 64, V, 1, 2.0, 1e-8, ints.data_ptr(),
                      floats.data_ptr(), stream)
            if code:
                raise RuntimeError(f"K8 {variant}: launch failed {code}")

        table = packed.clone()
        call(table)
        got = table[touched]
        del table
        if variant not in UNCHECKED and "lines" not in reference:
            reference["lines"] = got
            want = k8.apply_run_updates_plain(packed.clone(), s_ids, g_rows,
                                              2.0, 64)[touched]
            print(f"[K8] {variant} vs plain (cumsum differences, another "
                  f"order of f32 adds): max abs diff "
                  f"{float((got - want).abs().max()):.3g}", flush=True)
        elif variant not in UNCHECKED and not torch.equal(
                got, reference["lines"]):
            raise RuntimeError(f"K8 {variant}: lines differ from the first "
                               f"variant's")
        table = packed.clone()
        parts = []
        row = {"kernel": "K8", "variant": variant,
               "run_rmw": event_ms(lambda: call(table)),
               "device": chip_smoke.device_ms(torch, lambda i: call(table),
                                              1, by_kernel=parts)}
        row.update((chip_smoke.kernel_name(key), ms) for ms, key in parts)
        if variant == "profiled":
            prof = (ctypes.c_ulonglong * 4)()
            lib.run_rmw_prof(prof)
            before = list(prof)
            call(table)
            torch.cuda.synchronize()
            lib.run_rmw_prof(prof)
            cycles = [b - a for a, b in zip(before, prof)]
            row["tile pass: warp cycles a tile"] = (
                cycles[0] / -(-n // k8.TILE_ROWS))
            for i, what in ((1, "waiting for the ring"),
                            (2, "line updates"), (3, "row flags")):
                row[f"tile pass: {what}"] = cycles[i] / cycles[0]
        del table
        return row

    order = ["committed", *[v for v in K1_VARIANTS if v != "committed"],
             "committed"]
    k8_order = ["committed", *[v for v in K8_VARIANTS if v != "committed"],
                "committed"]
    if args.parent is not None:
        order = ["parent", *order, "parent"]
        k8_order = ["parent", *k8_order, "parent"]
    for variant in order:
        print(json.dumps(k1_row(variant)), flush=True)
    for variant in k8_order:
        print(json.dumps(k8_row(variant)), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
