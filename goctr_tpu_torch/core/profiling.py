"""Spans of the port's own code, and the profiler trace that shows them
(port of goctr_tpu/core/profiling.py: the reference's tracing is vestigial
pprof imports; here torch.profiler traces the host and the card).

`span(name)` marks a stretch of host code. It is off unless a torch
profiler is running or `record(True)` was called; off, it reads two flags
and returns one shared context that does nothing: it allocates nothing,
emits no host event and makes no CUDA call. On, each span

  - enters a host range that torch.profiler records as a `cpu_op` event
    (`_RecordFunctionFast`). `record_function` is not used: its
    user-scope range is also projected onto the card's timeline as a
    `gpu_user_annotation`, where it would read as device time, and it
    costs ~7.5 µs a call even with no profiler running;
  - appends a record to the store: its name, the span it opened in, the
    call it belongs to, and its host start and end from `time.time_ns()`,
    the clock of the profiler's host events, so that a store lays over a
    trace;
  - on a CUDA device (its own `device`, or its parent's), records a pair
    of timing events on the device's current stream at enter and exit.
    The events come from a pool reused across calls and are read only
    when the store is read, after the caller's own sync: spans add no
    sync. On the CPU a span's device time is its host time, since the
    ops run synchronously there.

The store holds the newest outermost span and every span inside it (in
the scanned trainer, the newest `goctr.train` call), so it never holds
more than one call; it starts again when an outermost span opens.
`spans()` returns its records with their device times. Spans nest on one
thread at a time.

    with profiling.trace("traces/train") as prof:      # spans on
        train_sparse_scanned(...)
    for s in profiling.spans(): ...                     # after the call
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:     # a torch build without it: the store alone records
    _RecordFunctionFast = None

# set by record(); a running profiler turns spans on by itself
_recording = False


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a Chrome/Perfetto trace of the enclosed block, CPU and (with
    a card) CUDA activity, written into `log_dir`:
        with profiling.trace("traces/step") as prof:
            train_sparse_scanned(...)
    View the .pt.trace.json with Perfetto or chrome://tracing; the port's
    spans show there as host ops by name. `prof`'s key_averages() sums the
    block by op and kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


def record(on: bool = True) -> None:
    """Record spans into the store with no profiler running (a running
    profiler records them whatever this says)."""
    global _recording
    _recording = bool(on)


@dataclasses.dataclass(frozen=True)
class Span:
    """One span of the newest call, as `spans()` returns it."""
    name: str
    parent: Optional[int]   # index in spans() of the span it opened in
    call: int               # the number of the call (outermost span)
    start_ns: int           # host clock, time.time_ns()
    end_ns: Optional[int]   # None while the span is open
    # device ms from the call's first timed span's start to this one's
    # start, and from its start to its end (host times on the CPU; None
    # while open)
    device_start_ms: Optional[float]
    device_ms: Optional[float]

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


# the one context every span that is off returns
_OFF = contextlib.nullcontext()


class _Store:
    """The newest call's spans, the open ones' stack and the pool of
    timing events (by device)."""

    def __init__(self):
        self.records: list[_Open] = []
        self.stack: list[_Open] = []
        self.call = 0
        self.pool: dict = {}

    def start_call(self) -> None:
        for r in self.records:
            if r.events is not None:
                self.pool.setdefault(r.device, []).extend(r.events)
        self.records = []
        self.call += 1

    def event(self, device: torch.device) -> torch.cuda.Event:
        free = self.pool.get(device)
        return free.pop() if free else torch.cuda.Event(enable_timing=True)


_STORE = _Store()


class _Open:
    """A span that is on: its context and its record in the store."""
    __slots__ = ("name", "device", "index", "parent", "call", "host",
                 "stream", "events", "start_ns", "end_ns", "read")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name, self.device = name, device

    def __enter__(self):
        st = _STORE
        parent = st.stack[-1] if st.stack else None
        if parent is None:
            st.start_call()
        elif self.device is None:
            self.device = parent.device
        self.parent = None if parent is None else parent.index
        self.index, self.call = len(st.records), st.call
        self.end_ns, self.read = None, None
        st.records.append(self)
        st.stack.append(self)
        self.host = None
        if _RecordFunctionFast is not None:
            self.host = _RecordFunctionFast(self.name)
            self.host.__enter__()
        self.events = None
        if self.device is not None and self.device.type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
            self.events = (st.event(self.device), st.event(self.device))
            self.events[0].record(self.stream)
        self.start_ns = time.time_ns()

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record(self.stream)
        if self.host is not None:
            self.host.__exit__(None, None, None)
        _STORE.stack.pop()
        return False


def span(name: str, device: Optional[torch.device] = None):
    """A context that records the enclosed code as the span `name` when
    spans are on (module docstring), and does nothing otherwise. `device`
    is the device whose current stream times it; without one a span takes
    its parent's, and an outermost span without one has host times only."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Open(name, device)


def spans() -> list[Span]:
    """The newest call's spans in the order they opened, each with its
    device times. CUDA events are read here, each waiting for its span's
    end: read after the call."""
    recs = _STORE.records
    if not recs:
        return []
    origin = next((r.events[0] for r in recs if r.events is not None), None)
    out = []
    for r in recs:
        if r.read is None and r.end_ns is not None:
            if r.events is not None:
                r.events[1].synchronize()
                r.read = (origin.elapsed_time(r.events[0]),
                          r.events[0].elapsed_time(r.events[1]))
            else:
                r.read = ((r.start_ns - recs[0].start_ns) / 1e6,
                          (r.end_ns - r.start_ns) / 1e6)
        dstart, dms = r.read if r.read is not None else (None, None)
        out.append(Span(r.name, r.parent, r.call, r.start_ns, r.end_ns,
                        dstart, dms))
    return out
