"""Timing on the card: CUDA events around a run of calls, and device time
by kernel from torch.profiler.

    cuda_ms(fn)                 ms a call of fn() between two CUDA events
    device_ms(fn, n_inputs)     device ms a call of fn(i), summed over the
                                kernels and copies it runs
    device_events(prof)         (self device us, count, name) of a profile
    kernel_name(key)            a profiler key's function name

`chip_smoke.py`, `goctr_tpu_torch.bench_kernels` and the sweep scripts
under `scripts/` (through `chip_smoke`) time the port with these.
"""
from __future__ import annotations

import re

import torch


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """ms a call of fn(): `warmup` calls, then `iters` calls between two
    CUDA events (host launch gaps included)."""
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


def device_events(prof) -> list[tuple[float, int, str]]:
    """(self device us, count, name) of every kernel and copy profiled,
    largest first."""
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue                    # host ops: their kernels are listed
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.count, e.key))
    return sorted(rows, reverse=True)


def kernel_name(key: str) -> str:
    """A profiler key's function name (`ns::name<...>(args)` → name), with
    the innermost functor it is instantiated with, if any
    (`elementwise_kernel<..., MulFunctor<float>>` → `elementwise_kernel
    MulFunctor`); a copy or memset keeps its kind (`Memcpy DtoD`)."""
    if key.startswith("Mem"):
        return key.split(" (")[0]
    m = re.search(r"(\w+)[<(]", key)
    if not m:
        return key[:40]
    functors = re.findall(r"\w*Functor\w*", key[m.end():])
    return f"{m[1]} {functors[-1]}" if functors else m[1]


def device_ms(fn, n_inputs: int, iters: int = 24, by_kernel=None) -> float:
    """Device time of one call of fn(i), from every kernel and copy that
    `iters` calls (cycling over n_inputs input sets) ran, by
    torch.profiler. Host launch gaps are not counted. A list given as
    `by_kernel` receives (ms per call, name) of each kernel.
    The profiler loses events: on an H100 most profiles miss one launch
    of 24, and one lost a third of them. Every call runs the same
    kernels, so each kernel's time per call is its mean time a launch
    times its launches a call (its count over iters, rounded); a profile
    that recorded nothing is taken again."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(n_inputs):
        fn(i)
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i % n_inputs)
            torch.cuda.synchronize()
        rows = device_events(prof)
        if rows:
            break
    per_call = [(us / count * max(1, round(count / iters)) / 1e3, key)
                for us, count, key in rows]
    if by_kernel is not None:
        by_kernel.extend(per_call)
    return sum(ms for ms, _ in per_call)
