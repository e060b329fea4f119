#!/usr/bin/env python3
"""Time the row gather (K1, csrc/row_gather.cu), the sorted-run row
update (K8, csrc/run_rmw.cu) and the run-sum compaction (K9,
csrc/compact_runsums.cu) against variants of their design, on one NVIDIA
card, at the main paths' shapes:

    python3 scripts/gather_run_sweep.py [--parent DIR] [--kernels K1,K8,K9]

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
K9's variants:
  committed           as in the tree;
  profiled            the committed source with its clock64 phase timers
                      on (kProfile: the warps' cycles by phase);
  registers           the rows as float4 loads into registers, kLoads
                      steps in flight a lane (committed: a ring of bulk
                      copies into shared memory);
  3 / 4 stages        kStages ring stages a warp (committed: 2);
  256-row tiles       kTileRows 256 (committed: 128);
  6 blocks            __launch_bounds__ asks for 6 blocks of 4 warps an
                      SM (at most 80 registers; committed: 8, 64);
  fill launch         the junk slots filled by a second launch (committed:
                      by the pass's own warps after the last tile);
  look-back 4         four windows of 32 tile words a round trip in the
                      look-back (committed: kLookBack 1);
  4 tails             kTailsInFlight tails a lane loads at once while it
                      sums a carry (committed: 8);
  no carries, no row writes, no look-back
                      what the parts cost: without the carries' waits and
                      sums, without the row writes, without the look-back
                      (slots 30 a tile; wrong outputs, not checked).
Beside them, yardsticks of the card's memory on the same tensors (PyTorch
calls, not used by the port): a read of g (sum), a write of the output
rows (zero_) and a copy of g.
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
version is printed. K9 compacts the headline's ids, sorted, with N(0, 1)
gradient rows at D = 64 (capr 596,992) and D = 16 (capr 768,000, the
grouped path's); every K9 variant (the parent too) is held to the plain
version as chip_smoke.py holds it (targets and overflow equal, run sums
within RUNSUM_RTOL·Σ|g|, lanes past D zero) and to itself bit for bit on
a repeat.
Prints one JSON line a variant: ms per call (CUDA events over 40 calls
after 5; for K8 and K9 also the device time of their kernels and device
operations, torch.profiler over 24 calls); then the card's name and
power limit.
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
from goctr_tpu_torch.ops.kernels import compact as k9  # noqa: E402
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

# phases of the timed build (csrc/compact_runsums.cu enum Phase)
K9_PHASES = ("begin (ticket, ids, first rows)", "look-back", "row walk",
             "tail", "carry wait", "carry sum", "fill")
K9_VARIANTS = {
    "committed": [],
    "profiled": [(r"constexpr bool kProfile = false;",
                  "constexpr bool kProfile = true;")],
    "registers": [(r"constexpr bool kUseRing = true;",
                   "constexpr bool kUseRing = false;")],
    "3 stages": [(r"constexpr int kStages = \d+;",
                  "constexpr int kStages = 3;")],
    "4 stages": [(r"constexpr int kStages = \d+;",
                  "constexpr int kStages = 4;")],
    "256-row tiles": [(r"constexpr int kTileRows = \d+;",
                       "constexpr int kTileRows = 256;")],
    "6 blocks": [(r"constexpr int kMinBlocks = \d+;",
                  "constexpr int kMinBlocks = 6;")],
    "fill launch": [(r"constexpr bool kFillInPass = true;",
                     "constexpr bool kFillInPass = false;")],
    "look-back 4": [(r"constexpr int kLookBack = \d+;",
                     "constexpr int kLookBack = 4;")],
    "4 tails": [(r"constexpr int kTailsInFlight = \d+;",
                 "constexpr int kTailsInFlight = 4;")],
    # what the parts cost (wrong outputs, not checked): no carries (no
    # wait for tails), no row writes but the carried ones
    "no carries": [(r"  if \(w.held_slot >= 0\) \{\n",
                    "  if (false) {\n")],
    "no row writes": [(r"\} else if \(slot < a.capr\) \{\n",
                       "} else if (false) {\n")],
    "no look-back": [(r"const long long first = look_back\(a, t, lane\);",
                      "const long long first = t * 30;")],
}

UNCHECKED = {"no line loads", "no line updates", "copies only",
             "no carries", "no row writes", "no look-back"}
HEADERS = ("bulk_copy.cuh", "line_update.cuh")
K1_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]
K9_ARGS = k9._ARGTYPES["compact_runsums"]
K9_CAPR = {64: 596_992, 16: 768_000}
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


SOURCES = {"K1": ("row_gather", K1_VARIANTS), "K8": ("run_rmw", K8_VARIANTS),
           "K9": ("compact_runsums", K9_VARIANTS)}


def build_all(parent: Path | None,
              kernels: list[str]) -> dict[tuple[str, str], Path]:
    """Every variant's library, built in parallel: {(kernel, variant)}."""
    jobs = {}
    base = _build.BUILD_DIR / "sweep"
    for name, variants in (SOURCES[k] for k in kernels):
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
    ap.add_argument("--kernels", default="K1,K8,K9",
                    help="which kernels to time, of K1, K8, K9")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(SOURCES):
        ap.error(f"--kernels takes {', '.join(SOURCES)}")
    if not torch.cuda.is_available():
        print("gather_run_sweep: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    libs = build_all(args.parent, kernels)
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

    k9_inputs = {}
    for d in K9_CAPR if "K9" in kernels else ():
        g_d = torch.randn(n, d, generator=gen, device=dev)
        want = k9.compact_runsums_plain(s_ids, g_d, V, K9_CAPR[d])
        abs_rows = k9.compact_runsums_plain(s_ids, g_d.abs(), V,
                                            K9_CAPR[d])[1]
        k9_inputs[d] = (g_d, want, chip_smoke.RUNSUM_RTOL * abs_rows[:, :d])
        del abs_rows
    k9_reps = {}

    def k9_row(variant):
        lib = ctypes.CDLL(str(libs["compact_runsums", variant]))
        fn = lib.compact_runsums
        fn.restype = ctypes.c_int
        fn.argtypes = K9_ARGS
        row = {"kernel": "K9", "variant": variant}
        for d, (g_d, want, lim) in k9_inputs.items():
            capr = K9_CAPR[d]
            n_tiles = -(-n // k9.TILE_ROWS)
            if variant == "parent":      # the seven-launch layout's scratch
                n_groups = -(-n_tiles // 128)
                scratch = [torch.empty(4 * n_tiles + n_groups + 1,
                                       dtype=torch.int32, device=dev),
                           torch.empty((n_tiles + 2 * n_groups) * d,
                                       device=dev)]
            else:
                scratch = [torch.empty(k9.scratch_words(n, d),
                                       dtype=torch.int64, device=dev)]
            fn.argtypes = K9_ARGS + [ctypes.c_void_p] * (len(scratch) - 1)
            tgt = torch.empty(capr, dtype=torch.int32, device=dev)
            rows = torch.empty(capr, 128, device=dev)
            over = torch.empty((), dtype=torch.int32, device=dev)

            def call():
                code = fn(s_ids.data_ptr(), g_d.data_ptr(), n, d, V, capr,
                          tgt.data_ptr(), rows.data_ptr(), over.data_ptr(),
                          *(x.data_ptr() for x in scratch), stream)
                if code:
                    raise RuntimeError(f"K9 {variant}: launch failed {code}")

            call()
            torch.cuda.synchronize()
            first = (tgt.clone(), rows.clone(), over.clone())
            diff = (rows[:, :d] - want[1][:, :d]).abs()
            if variant in UNCHECKED:
                pass
            elif not (torch.equal(tgt, want[0])
                    and int(over) == int(want[2])):
                raise RuntimeError(f"K9 {variant} D={d}: targets or "
                                   f"overflow differ from plain")
            elif not bool((diff <= lim).all()):
                raise RuntimeError(
                    f"K9 {variant} D={d}: {int((diff > lim).sum())} run "
                    f"sums outside RUNSUM_RTOL·Σ|g|")
            elif not bool((rows[:, d + 1:] == 0).all()):
                raise RuntimeError(f"K9 {variant} D={d}: lanes past D not 0")
            call()
            torch.cuda.synchronize()
            if variant not in UNCHECKED and not all(
                    torch.equal(x, y) for x, y in
                    zip(first, (tgt, rows, over))):
                raise RuntimeError(f"K9 {variant} D={d}: a repeat differs")
            if variant == "committed" and d in k9_reps and not torch.equal(
                    rows, k9_reps[d]):
                raise RuntimeError(f"K9 committed D={d}: differs between "
                                   "its two runs")
            if variant == "committed":
                k9_reps.setdefault(d, rows.clone())
            row[f"D={d} max err"] = float(diff.max())
            row[f"D={d} ms"] = event_ms(call)
            parts = []
            row[f"D={d} device"] = chip_smoke.device_ms(
                torch, lambda i: call(), 1, by_kernel=parts)
            row[f"D={d} by kernel"] = {chip_smoke.kernel_name(key): ms
                                       for ms, key in parts}
            if variant == "profiled":
                prof = (ctypes.c_ulonglong * (len(K9_PHASES) + 1))()
                lib.compact_runsums_prof(prof)
                before = list(prof)
                call()
                torch.cuda.synchronize()
                lib.compact_runsums_prof(prof)
                cyc = [b - a for a, b in zip(before, prof)]
                warp_cycles = sum(cyc[:-1])
                row[f"D={d} warp cycles a 128 rows"] = warp_cycles / n_tiles
                row[f"D={d} carried tiles"] = cyc[-1]
                row[f"D={d} shares"] = {
                    what: cyc[i] / warp_cycles
                    for i, what in enumerate(K9_PHASES)}
            del first, diff, tgt, rows, scratch
        return row

    def yardsticks():
        """Achieved bytes/s of PyTorch's own passes over K9's tensors."""
        row = {"kernel": "K9", "variant": "yardsticks (PyTorch)"}
        for d, (g_d, _, _) in k9_inputs.items():
            rows = torch.empty(K9_CAPR[d], 128, device=dev)
            copy = torch.empty_like(g_d)
            for what, fn, nbytes in (
                    ("read g (sum)", lambda: g_d.sum(), g_d.numel() * 4),
                    ("write rows (zero_)", rows.zero_, rows.numel() * 4),
                    ("copy g", lambda: copy.copy_(g_d),
                     2 * g_d.numel() * 4)):
                ms = event_ms(fn)
                row[f"D={d} {what} ms"] = ms
                row[f"D={d} {what} TB/s"] = nbytes / ms / 1e9
            del rows, copy
        return row

    plans = {"K1": (K1_VARIANTS, k1_row), "K8": (K8_VARIANTS, k8_row),
             "K9": (K9_VARIANTS, k9_row)}
    if "K9" in kernels:
        print(json.dumps(yardsticks()), flush=True)
    for kernel in kernels:
        variants, row_fn = plans[kernel]
        order = ["committed", *[v for v in variants if v != "committed"],
                 "committed"]
        if args.parent is not None:
            order = ["parent", *order, "parent"]
        for variant in order:
            print(json.dumps(row_fn(variant)), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
