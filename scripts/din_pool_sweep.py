#!/usr/bin/env python3
"""Time the DIN pool kernels (K2 csrc/din_attention.cu, K2b
csrc/din_attention_bwd.cu) against variants of their design, on one
NVIDIA card, at the main paths' shapes:

    python3 scripts/din_pool_sweep.py      (from the repository root)

Each variant is the committed source with one change, built into its own
library under goctr_tpu_torch/_build/sweep/ (git-ignored):
  ring (as committed)  the bulk-copy ring, 2 stages of 4 KB a warp;
  3 stages             the ring with 3 stages;
  registers            no ring: each trip loads its rows from global
                       memory straight into registers (the register route);
  ring only            the ring with no math (what the copies alone take).
"ring only" computes nothing: its outputs are not checked. Every other
variant is held to the plain version (one bf16 ulp, as the card tests).
Prints one JSON line a variant: ms per call (CUDA events over 40 calls
after 5) for K2 at B = 65,536 / 16,384 (D = 64) and 65,536 (D = 16), and
K2b at B = 65,536 (D = 64, 16), T = 32, bf16; then the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from goctr_tpu_torch.ops.kernels import _build  # noqa: E402
from goctr_tpu_torch.ops.kernels import din_attention as k2  # noqa: E402

SHAPES_K2 = [(65536, 32, 64), (16384, 32, 64), (65536, 32, 16)]
SHAPES_K2B = [(65536, 32, 64), (65536, 32, 16)]
# (source text, replacement) a variant applies to every pool source
VARIANTS = {
    "ring (as committed)": [],
    "3 stages": [(r"constexpr int kStages = \d+;", "constexpr int kStages = 3;")],
    "registers": [
        (r"const T\* stage = ring\.wait\(u\);",
         "const T* stage = beh + x.row0(seq) * dim;"),
        (r"for \(int u = 0; u < kStages && u < n_units; \+\+u\) issue\(u\);",
         ""),
        (r"if \(lane == 0 && u \+ kStages < n_units\) issue\(u \+ kStages\);",
         "(void)0;")],
    "ring only": [
        (r"for \(int p0 = 0; p0 < x\.nb; p0 \+= Q\)",
         "for (int p0 = 0; p0 < 0; p0 += Q)")],
}
SOURCES = ("bulk_copy.cuh", "din_pool.cuh", "din_attention.cu",
           "din_attention_bwd.cu")
FWD = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 2 \
    + [ctypes.c_void_p, ctypes.c_int]
BWD = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 2 \
    + [ctypes.c_void_p, ctypes.c_int]


def build(name: str, subs) -> tuple[ctypes.CDLL, ctypes.CDLL]:
    """The variant's K2 and K2b libraries, built in parallel."""
    out = _build.BUILD_DIR / "sweep" / re.sub(r"\W+", "_", name)
    out.mkdir(parents=True, exist_ok=True)
    for src in SOURCES:
        text = (_build.CSRC / src).read_text()
        for pattern, repl in subs:
            text = re.sub(pattern, repl, text)
        (out / src).write_text(text)
    procs = [subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{s}.so"),
         str(out / f"{s}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for s in ("din_attention", "din_attention_bwd")]
    for p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: build failed\n{log}")
    fwd = ctypes.CDLL(str(out / "libdin_attention.so"))
    bwd = ctypes.CDLL(str(out / "libdin_attention_bwd.so"))
    for fn, types in ((fwd.din_attention_bf16, FWD),
                      (bwd.din_attention_bwd_bf16, BWD)):
        fn.argtypes, fn.restype = types, ctypes.c_int
    return fwd, bwd


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


def main() -> int:
    if not torch.cuda.is_available():
        print("din_pool_sweep: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    n_sms = k2.sm_count(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    data = {}
    for b, t, d in set(SHAPES_K2 + SHAPES_K2B):
        beh = torch.randn(b, t, d, device=dev, generator=gen).bfloat16()
        item = torch.randn(b, d, device=dev, generator=gen).bfloat16()
        dout = torch.randn(b, d, device=dev, generator=gen).bfloat16()
        att0 = torch.randn(t, device=dev, generator=gen) * 0.3 + 1
        mask = (torch.rand(b, t, device=dev, generator=gen) > 0.2).float()
        data[b, t, d] = (dout, beh, item, att0, mask)
    for name, subs in VARIANTS.items():
        fwd, bwd = build(name, subs)
        row = {"variant": name}
        for b, t, d in SHAPES_K2:
            _, beh, item, att0, mask = data[b, t, d]
            out = torch.empty(b, d, device=dev, dtype=torch.bfloat16)

            def call():
                code = fwd.din_attention_bf16(
                    beh.data_ptr(), item.data_ptr(), att0.data_ptr(),
                    mask.data_ptr(), out.data_ptr(), b, t, d, stream, n_sms)
                if code:
                    raise RuntimeError(f"{name}: K2 launch failed ({code})")

            call()
            if name != "ring only":
                want = k2.din_attention_pool_plain(beh, item, att0, mask)
                torch.testing.assert_close(out.float(), want.float(),
                                           atol=1e-6, rtol=2.0 ** -7)
            row[f"K2 B={b} D={d}"] = event_ms(call)
        for b, t, d in SHAPES_K2B:
            dout, beh, item, att0, mask = data[b, t, d]
            d_beh, d_item = torch.empty_like(beh), torch.empty_like(item)
            d_att0 = torch.empty(t, device=dev)
            part = torch.empty(k2.bwd_partial_floats(b, t, n_sms),
                               device=dev)

            def call():
                code = bwd.din_attention_bwd_bf16(
                    dout.data_ptr(), beh.data_ptr(), item.data_ptr(),
                    att0.data_ptr(), mask.data_ptr(), d_beh.data_ptr(),
                    d_item.data_ptr(), d_att0.data_ptr(), part.data_ptr(),
                    b, t, d, stream, n_sms)
                if code:
                    raise RuntimeError(f"{name}: K2b launch failed ({code})")

            call()
            if name != "ring only":
                want = k2.din_attention_pool_bwd_plain(dout, beh, item, att0,
                                                       mask)
                torch.testing.assert_close(d_beh.float(), want[0].float(),
                                           atol=1e-6 * float(
                                               want[0].float().abs().max()),
                                           rtol=2.0 ** -7)
            row[f"K2b B={b} D={d}"] = event_ms(call)
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
