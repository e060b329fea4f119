#!/usr/bin/env python3
"""Each stage of the scanned trainer's step by device op, for one cell of
the benchmark: runs `benchmark/run.py --trace 1` (its output unchanged),
then lays the program's spans of the last traced window
(goctr_tpu_torch/core/profiling.py) over that window's trace. A device op
belongs to the innermost span open on the host when its launch (the CUDA
runtime call with the same correlation id) began: the spans' host times
and the profiler's host events share one clock.

    python3 scripts/stage_kernels.py --workload <cell> --seed <n>
                                     [--seconds 40] [--top 6]

After the run's own lines, prints one JSON line to standard output:
{"steps", "step_period_ms" (mean and p95 by nearest rank of the device
step period, as train_step_p95_ms takes it), "stages_sum_ms" (the six
stages' mean device ms, summed), "stages": {span: {"ms_step" (device ms
of its ops a step), "ops": [[op, ms a step], ...]}}, "unmatched" (device
ops with no launch found)}. Needs a card, as run.py does.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def keep_events(trace) -> list:
    """Wraps trace.reduce so that each traced window's events are also
    kept, the newest window's alone: its device ops as (True, name, start
    ns, duration ns, (correlation id, linked correlation id)) and its CUDA
    API calls (`cuda*`, `cu*`) as (False, name, start ns, duration ns,
    correlation id)."""
    held: list = []
    real = trace.reduce

    def reduce(prof):
        held.clear()
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            if trace._device_type(ev) == "CUDA":
                if name != trace.WINDOW_SPAN:
                    held.append((True, name, ev.start_ns(), ev.duration_ns(),
                                 (ev.correlation_id(),
                                  ev.linked_correlation_id())))
            elif name.startswith("cu"):
                held.append((False, name, ev.start_ns(), ev.duration_ns(),
                             ev.correlation_id()))
        return real(prof)

    trace.reduce = reduce
    return held


def innermost(spans, starts, t: int):
    """Index of the innermost span open at host time t, or None."""
    i = bisect.bisect_right(starts, t) - 1
    while i is not None and i >= 0:
        s = spans[i]
        if s.end_ns is not None and s.start_ns <= t <= s.end_ns:
            return i
        i = s.parent
    return None


def by_stage(events: list, spans: list, top: int) -> dict:
    from benchmark.program_spans import STEP, nearest_rank, step_periods_ms
    from benchmark.trace import short_name

    starts = [s.start_ns for s in spans]
    launch = {corr: t for dev, _, t, _, corr in events if not dev}
    steps = sum(s.name == STEP for s in spans)
    stages: dict = {}
    unmatched = 0
    for dev, name, _, dur, corr in events:
        if not dev:
            continue
        t = launch.get(corr[0], launch.get(corr[1]))
        i = None if t is None else innermost(spans, starts, t)
        if i is None:
            unmatched += 1
            continue
        ops = stages.setdefault(spans[i].name, {})
        op = short_name(name)
        ops[op] = ops.get(op, 0.0) + dur / 1e6
    periods = step_periods_ms(spans)
    stage_ms = [statistics.fmean([s.device_ms for s in spans
                                  if s.name == f"goctr.train.{n}"])
                for n in ("batch", "lookup", "fwd_bwd", "solver",
                          "update_front", "update_rmw")]
    out = {}
    for span, ops in sorted(stages.items(), key=lambda kv: -sum(
            kv[1].values())):
        ranked = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        out[span] = {"ms_step": sum(ops.values()) / steps,
                     "ops": [[k, v / steps] for k, v in ranked]}
    return {"steps": steps,
            "step_period_ms": {"mean": statistics.fmean(periods),
                               "p95": nearest_rank(periods, 0.95)},
            "stages_sum_ms": sum(stage_ms), "stages": out,
            "unmatched": unmatched}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args(argv)

    from benchmark import run, trace
    from goctr_tpu_torch.core import profiling

    events = keep_events(trace)
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc:
        return rc
    print(json.dumps(by_stage(events, profiling.spans(), args.top)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
