"""Tracing/profiling helpers (port of goctr_tpu/core/profiling.py: the
reference's tracing is vestigial pprof imports; here torch.profiler
traces the host and the card, beside per-step timing)."""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a Chrome/Perfetto trace of the enclosed block, CPU and (with
    a card) CUDA activity, written into `log_dir`:
        with profiling.trace("traces/step") as prof:
            train_step(...)
    View the .pt.trace.json with Perfetto or chrome://tracing; `prof`'s
    key_averages() sums the block by op and kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


class StepTimer:
    """Wall-clock per-step timing with jitter stats (the reference prints
    epoch wall times via cheggaaa/pb; this gives programmatic access)."""

    def __init__(self):
        self.times: list[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    @property
    def median(self) -> float:
        s = sorted(self.times)
        return s[len(s) // 2] if s else 0.0

    def summary(self) -> dict:
        if not self.times:
            return {}
        s = sorted(self.times)
        n = len(s)
        return {"n": n, "median_s": s[n // 2], "min_s": s[0], "max_s": s[-1],
                "total_s": sum(s)}


def annotate(name: str):
    """Named region visible in profiler traces
    (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)
