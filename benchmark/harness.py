"""One run of one cell: set-up, the window, the check, for any family
(families/__init__.py has the interface; the cell's family and reference
come from its configuration).

Set-up draws the traffic and the weights on the device from the seed and
drives the program through its first three steps in two calls, step 1
alone and steps 2-3 together (CALLS), which builds and loads every
kernel the window runs. The window's epochs E are the run's seconds over
the cell's stated epoch time (cells/<cell>.json `epoch_s`, the window's
seconds an epoch on the card, its `epoch_why` says when and how it was
taken), rounded, at least 2: a fixed
amount of work for a given run length, the same in every run, so that a
rate never moves with E. The window is one call of the program over E
epochs of the draw, resumed from the second call's result. With `trace`
the untraced window runs first, for the rate that the step's shares and
the idle share are taken over, and then the same call again under
torch.profiler. Once the windows have closed, and the program's state is
freed, the reference follows the first three steps on the rows the
program's own order gave each step (the family's `warm_batches`), and
check.py compares; it also holds each window to the work it was asked
for: E epochs, and every counted kernel launched as many times a step as
in steps 2-3.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import torch

from benchmark import check, counts, trace
from benchmark.families import Inputs, Readings
from benchmark.registry import Bench, Cell

WARM_STEPS = 3
# the steps of each set-up call: step 1 alone (its gradients are read from
# the result), then the rest in one call of the trainer's own loop
CALLS = (1, WARM_STEPS - 1)
# traced windows taken at most, while the trace lacks more than LOST_SHARE
# of the counted launches (the profiler drops a few events in most traces)
TRACE_ATTEMPTS = 3
LOST_SHARE = 0.01
# another traced window is taken only if the run, from its start, would
# still end within this many seconds
TRACE_BUDGET_S = 300.0


def prepare(cell: Cell, seed: int, device: torch.device) -> Inputs:
    inputs = cell.family.draw(cell.config, cell.traffic, seed, device)
    if inputs.rows < WARM_STEPS * cell.traffic["batch"]:
        raise ValueError("the draw holds fewer rows than the first steps")
    return inputs


def program_first(cell: Cell, prep: Inputs, seed: int,
                  device: torch.device):
    """(Program, Readings, state after the first steps, overflow, the
    counted kernels' launches in the call of steps 2-3)."""
    fam = cell.family
    prog = fam.Program(cell.config, cell.traffic, prep, device)
    weights = fam.initial(cell.config, cell.traffic, seed, device)
    readings, state, over, counted = prog.first_steps(
        prep.arrays, weights, seed, CALLS)
    return prog, readings, state, over, counted


def per_call(losses: list) -> list:
    """Step losses → one a set-up call, the mean of its steps', as the
    trainer reports one an epoch."""
    out, i = [], 0
    for steps in CALLS:
        out.append(sum(losses[i:i + steps]) / steps)
        i += steps
    return out


def reference_first(cell: Cell, prep: Inputs, seed: int,
                    device: torch.device, **kw) -> Readings:
    """The reference's first steps from the same inputs, drawn again, with
    its losses one a set-up call."""
    fam = cell.family
    weights = fam.initial(cell.config, cell.traffic, seed, device)
    r = cell.reference.first_steps(
        cell.config, weights,
        fam.warm_batches(cell.config, cell.traffic, prep, seed, CALLS,
                         device), **kw)
    return dataclasses.replace(r, losses=per_call(r.losses))


@dataclasses.dataclass
class TraceData:
    """What a per-layer reader reads (metrics/*.py). `window_s` is the
    traced window's length; `rate_window_s` the untraced window's, over
    which the run's rate is taken."""
    profile: trace.Profile
    classes: dict
    launches: dict
    steps: int
    examples: int
    window_s: float
    rate_window_s: float
    flops_per_example: float
    needed_bytes_per_example: float
    kernel_bytes: dict     # bytes a step by kernel group (the family's)
    peak_flops: float
    peak_bytes: float

    def class_ms(self, wanted) -> float:
        return trace.class_ms(self.profile, self.classes, self.launches,
                              wanted)


@dataclasses.dataclass
class Window:
    """What one window's call gave: its result's overflow and steps with a
    loss that is not finite, its seconds, and how far its work is from
    what it was asked (epochs missing or extra; launches of counted
    kernels off from the steps × their launches a step in steps 2-3)."""
    overflow: int
    nonfinite: int
    seconds: float
    epochs_off: int
    launches_off: float
    steps_run: int
    launches: dict


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(bench: Bench, cell: Cell, seed: int, seconds: float,
             traced: bool, device: torch.device, t_start: float):
    """One run: (the result line without the module check, the window's
    epochs, every number check.py read)."""
    cuda = device.type == "cuda"
    law, fam = cell.traffic, cell.family
    prep = prepare(cell, seed, device)
    print(f"draw: distinct ids a batch {prep.unique_share:.4f}, compact_cap "
          f"{prep.cap}", file=sys.stderr)
    prog, first, state, over, counted = program_first(cell, prep, seed,
                                                      device)
    _free(device)
    epochs = max(2, round(seconds / cell.epoch_s))
    batches = -(-prep.rows // law["batch"])
    steps = epochs * batches
    per_step = {k: v / CALLS[-1] for k, v in counted.items()}

    def window():
        return _window(prog, prep, epochs, seed, state, batches, per_step)

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    windows = [window()]
    prof_data = None
    if traced:
        traced_w, prof_data = _traced_window(window, t_start)
        windows.append(traced_w)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    examples = epochs * prep.rows
    del state, prog
    _free(device)

    ref = reference_first(cell, prep, seed, device)
    values = check.numbers(first, ref)
    values.update(
        overflow=max([over] + [w.overflow for w in windows]),
        nonfinite=sum(w.nonfinite for w in windows),
        epochs_off=max(w.epochs_off for w in windows),
        launches_off=max(w.launches_off for w in windows))
    correct, checks = check.judge(values, {
        **cell.limits, "overflow": 0, "nonfinite": 0, "epochs_off": 0,
        "launches_off": 0})
    attempted = min(w.steps_run for w in windows)
    line = {"correct": correct, "attempted": attempted,
            "failed": attempted if values["overflow"] or
            values["nonfinite"] else 0}
    units = {x["name"]: x["unit"] for x in cell.end_to_end + cell.per_layer}
    if traced:
        name = torch.cuda.get_device_name(device) if cuda else ""
        flops_peak, bytes_peak = (counts.card_peaks(name) if cuda
                                  else (math.nan, math.nan))
        t = TraceData(
            profile=prof_data, classes=trace.load_classes(),
            launches=windows[-1].launches, steps=steps, examples=examples,
            window_s=windows[-1].seconds, rate_window_s=windows[0].seconds,
            flops_per_example=fam.flops_per_example(cell.config, law),
            needed_bytes_per_example=fam.needed_bytes_per_example(
                cell.config, law, prep),
            kernel_bytes=fam.kernel_bytes(cell.config, law),
            peak_flops=flops_peak, peak_bytes=bytes_peak)
        metrics = {}
        for x in cell.per_layer:
            v = bench.reader(x["name"])(t)
            if v is not None:
                metrics[x["name"]] = {"value": v, "unit": units[x["name"]]}
        line["metrics"] = metrics
    else:
        line["metrics"] = {
            "train_examples_per_s": {"value": examples / windows[0].seconds,
                                     "unit": units["train_examples_per_s"]},
            "peak_device_gb": {"value": peak / 1e9,
                               "unit": units["peak_device_gb"]},
            "setup_s": {"value": setup_s, "unit": units["setup_s"]}}
        line["metrics"] = {k: v for k, v in line["metrics"].items()
                           if k in units}
    line["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    if traced:
        line["device"].update(busy_s=prof_data.busy_s,
                              window_s=windows[-1].seconds)
        line["breakdown"] = trace.breakdown(prof_data)
        print(f"kernels in no class (s, name): "
              f"{trace.unclassified(prof_data, trace.load_classes())}",
              file=sys.stderr)
    line["checks"] = checks
    return line, epochs, values


def _window(prog, prep: Inputs, epochs: int, seed: int, state,
            batches: int, per_step: dict) -> Window:
    """One window's call."""
    c = prog.window(prep.arrays, epochs, seed, state)
    nonfinite = sum(1 for x in c.losses if not math.isfinite(x))
    steps = epochs * batches
    counted = c.launches
    off = sum(abs(counted[k] - steps * per_step[k]) for k in counted)
    ran = [counted[k] / per_step[k] for k in counted if per_step[k] > 0]
    steps_run = int(min(ran)) if ran else len(c.losses) * batches
    print(f"window: {c.seconds:.3f} s; epochs (s): "
          f"{[round(x, 4) for x in c.epoch_times]}", file=sys.stderr)
    return Window(c.overflow, nonfinite, c.seconds,
                  abs(len(c.losses) - epochs), off, steps_run, counted)


def _traced_window(window, t_start: float):
    """The window under torch.profiler, taken again (at most
    TRACE_ATTEMPTS times, and while the run would end within
    TRACE_BUDGET_S) while its trace lacks more than LOST_SHARE of the
    counted launches; the attempt that lacks fewest is kept. Returns
    (Window, Profile)."""
    from torch.profiler import ProfilerActivity, profile

    classes = trace.load_classes()
    best = None
    for _ in range(TRACE_ATTEMPTS):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            w = window()
        p = trace.reduce(prof)
        del prof
        lost = trace.lost_events(p, classes, w.launches)
        print(f"trace: {lost} of {sum(w.launches.values())} counted "
              f"launches missing", file=sys.stderr)
        if best is None or lost < best[0]:
            best = (lost, w, p)
        now = time.perf_counter()
        if (lost <= LOST_SHARE * sum(w.launches.values())
                or now - t_start + (now - t0) > TRACE_BUDGET_S):
            break
    return best[1], best[2]
