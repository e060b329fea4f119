"""The span readers (program_spans.py and its metrics): on a synthetic
store they give the step period's p95 by the nearest rank, each stage's
mean and the call's fixed share; on an empty store, or a program without
spans, nothing; and in a traced run of the tiny CPU cell every one of
them reports a number."""
import math
import time

import pytest
import torch

from benchmark import harness, program_spans, trace
from conftest import TINY_CELL
from goctr_tpu_torch.core import profiling
from goctr_tpu_torch.core.profiling import Span

READERS = ("train_step_p95_ms", "stage_batch_ms", "stage_lookup_ms",
           "stage_fwd_bwd_ms", "stage_solver_ms", "stage_update_front_ms",
           "stage_update_rmw_ms", "call_fixed_pct")
STAGES = ("batch", "lookup", "fwd_bwd", "solver", "update_front",
          "update_rmw")
MS = 1_000_000      # ns


def synthetic(epochs=2, steps=50):
    """One call: 10 ms of upload, 5 of resume, `epochs` epochs of `steps`
    steps, 5 ms of return (host ns; device ms on the same clock). Step k
    of an epoch takes 10 + k % 20 ms, its six stages 1..6 parts of 21 of
    it, and 1 ms passes between steps."""
    out = [None]

    def add(name, parent, start, end):
        out.append(Span(name, parent, 1, start, end, start / MS,
                        (end - start) / MS))
        return len(out) - 1

    add("goctr.train.upload", 0, 0, 10 * MS)
    add("goctr.train.resume", 0, 10 * MS, 15 * MS)
    t = 15 * MS
    for _ in range(epochs):
        ep, e0 = add("goctr.train.epoch", 0, t, t), t
        for k in range(steps):
            dur = (10 + k % 20) * MS
            st, s = add("goctr.train.step", ep, t, t + dur), t
            for i, name in enumerate(STAGES, 1):
                part = dur * i // 21
                add(f"goctr.train.{name}", st, s, s + part)
                s += part
            t += dur + MS
        out[ep] = Span("goctr.train.epoch", 0, 1, e0, t, e0 / MS,
                       (t - e0) / MS)
    add("goctr.train.return", 0, t, t + 5 * MS)
    t += 5 * MS
    out[0] = Span("goctr.train", None, 1, 0, t, 0.0, t / MS)
    return out


def reader(bench, name):
    return bench.reader(name)(None)


def test_readers_on_a_synthetic_store(tiny_bench, monkeypatch):
    spans = synthetic()
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    # periods: 11 + k % 20 ms between steps, the epoch's last 10 + 49 % 20
    periods = [11 + k % 20 for k in range(49)] + [10 + 49 % 20]
    ranked = sorted(periods * 2)
    assert program_spans.step_periods_ms(spans) == pytest.approx(
        periods * 2)
    assert reader(tiny_bench, "train_step_p95_ms") == pytest.approx(
        ranked[math.ceil(0.95 * 100) - 1])
    for i, name in enumerate(STAGES, 1):
        want = sum((10 + k % 20) * MS * i // 21 for k in range(50)) / 50
        assert reader(tiny_bench, f"stage_{name}_ms") == pytest.approx(
            want / MS)
    assert reader(tiny_bench, "call_fixed_pct") == pytest.approx(
        100 * 20 / (spans[0].host_s * 1e3))


@pytest.mark.parametrize("values,q,want", [
    ([5.0], 0.95, 5.0), (list(range(1, 21)), 0.95, 19),
    (list(range(1, 101)), 0.95, 95), (list(range(100, 0, -1)), 0.5, 50)])
def test_nearest_rank(values, q, want):
    assert program_spans.nearest_rank(values, q) == want


@pytest.mark.parametrize("store", ["empty", "no_call", "no_spans"])
def test_readers_read_nothing_without_a_call(tiny_bench, monkeypatch,
                                             store):
    if store == "empty":
        monkeypatch.setattr(profiling, "spans", lambda: [])
    elif store == "no_call":
        monkeypatch.setattr(profiling, "spans", lambda: [
            Span("other", None, 1, 0, MS, 0.0, 1.0)])
    else:       # a program older than its spans
        monkeypatch.delattr(profiling, "spans")
    assert all(reader(tiny_bench, r) is None for r in READERS)


def test_traced_tiny_run_reports_every_span_metric(tiny_bench):
    line, _, _ = harness.run_cell(tiny_bench, tiny_bench.cell(TINY_CELL),
                                  2**31 + 5, 0.5, True, torch.device("cpu"),
                                  time.perf_counter())
    assert line["correct"], line["checks"]
    for r in READERS:
        assert isinstance(line["metrics"][r]["value"], float), r
    assert 0 < line["metrics"]["call_fixed_pct"]["value"] < 100
    steps = [s for s in profiling.spans() if s.name == "goctr.train.step"]
    assert len(steps) == line["attempted"]


def test_spans_stay_off_the_device_timeline():
    """The spans are host events: trace.reduce lists none as a device
    op."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("goctr.train"):
            with profiling.span("goctr.train.step"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    p = trace.reduce(prof)
    assert not any(k.startswith("goctr.") for k in p.kernels)
