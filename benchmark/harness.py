"""One run of one cell: set-up, the window, the check.

Set-up draws the traffic and the weights on the device from the seed and
drives the trainer through its first three steps in two calls, step 1
alone and steps 2-3 together (program.py), which builds and loads every
kernel the window runs. The window's epochs E are the run's seconds over
the cell's stated epoch time (cells/<cell>.json `epoch_s`, an epoch's
time on the card when the cell was made), rounded, at least 2: a fixed
amount of work for a given run length, the same in every run, so that a
rate never moves with E. The window is one call of the trainer over E
epochs of the draw, resumed from the second call's result. With `trace`
the untraced window runs first, for the rate that the step's shares and
the idle share are taken over, and then the same call again under
torch.profiler. Once the windows have closed, and the program's state is
freed, the reference follows the first three steps (reference.py) on the
rows the trainer's own order gave each step, and check.py compares; it
also holds each window to the work it was asked for: E epochs, and every
counted kernel launched as many times a step as in steps 2-3.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import torch

from benchmark import check, counts, reference, trace, traffic, weights
from benchmark.program import Program
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


@dataclasses.dataclass
class Prepared:
    """A cell's inputs: the draw on the host, and what the harness counts
    on its own draw."""
    arrays: dict
    cap: int
    unique_share: float


def prepare(cell: Cell, seed: int, device: torch.device) -> Prepared:
    m, law = cell.config["model"], cell.traffic
    d = traffic.draw(law, m["item_vocab"], m["u_profile_dim"], m["ctx_dim"],
                     seed, device)
    if d.rows < WARM_STEPS * law["batch"]:
        raise ValueError("the draw holds fewer rows than the first steps")
    out = Prepared(d.host(), traffic.compact_cap(d, law["batch"]),
                   traffic.unique_share(d, law["batch"]))
    del d
    return out


def program_first(cell: Cell, prep: Prepared, seed: int,
                  device: torch.device):
    """(Program, Readings, state after the first steps, overflow, the
    counted kernels' launches in the call of steps 2-3)."""
    m, t = cell.config["model"], cell.traffic["t"]
    prog = Program(cell.config, t, cell.traffic["batch"], prep.cap, device)
    dense0 = weights.draw_dense(m, t, seed, device)
    table0 = weights.draw_table(m, t, seed, device)
    readings, state, over, counted = prog.first_steps(
        prep.arrays, dense0, table0, seed, CALLS)
    return prog, readings, state, over, counted


def trainer_order(seed: int, epochs_done: int, n: int, shuffle: bool,
                  device: torch.device) -> torch.Tensor:
    """The order in which the trainer takes the n rows of a call's epoch,
    as goctr_tpu_torch documents it (parallel/scanned.py
    `trainer_generator`, `epoch_order`; frozen copy): a randperm from a
    generator on the device seeded seed × 1,000,003 + the epochs already
    in the state handed in."""
    if not shuffle:
        return torch.arange(n, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 1_000_003 + epochs_done)
    return torch.randperm(n, generator=gen, device=device)


def warm_batches(cell: Cell, prep: Prepared, seed: int,
                 device: torch.device) -> list:
    """The first steps' batches, on the rows the trainer gives each step:
    each call of CALLS trains on the next rows of the draw, one epoch."""
    batch, out, start = cell.traffic["batch"], [], 0
    shuffle = cell.config["trainer"]["shuffle"]
    for done, steps in enumerate(CALLS):
        order = trainer_order(seed, done, steps * batch, shuffle, device)
        rows = (order + start).cpu().numpy()
        for s in range(steps):
            idx = rows[s * batch:(s + 1) * batch]
            out.append({k: torch.from_numpy(v[idx]).to(device)
                        for k, v in prep.arrays.items()})
        start += steps * batch
    return out


def per_call(losses: list) -> list:
    """Step losses → one a set-up call, the mean of its steps', as the
    trainer reports one an epoch."""
    out, i = [], 0
    for steps in CALLS:
        out.append(sum(losses[i:i + steps]) / steps)
        i += steps
    return out


def reference_first(cell: Cell, prep: Prepared, seed: int,
                    device: torch.device, **kw) -> reference.Readings:
    """The reference's first steps from the same inputs, drawn again, with
    its losses one a set-up call."""
    m, t = cell.config["model"], cell.traffic["t"]
    dense0 = weights.draw_dense(m, t, seed, device)
    table0 = weights.draw_table(m, t, seed, device)
    r = reference.first_steps(
        m, cell.config["trainer"], cell.config["table_opt"], dense0, table0,
        warm_batches(cell, prep, seed, device), **kw)
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
    pool_needed_bytes: float
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
    law, m = cell.traffic, cell.config["model"]
    prep = prepare(cell, seed, device)
    print(f"draw: distinct ids a batch {prep.unique_share:.4f}, compact_cap "
          f"{prep.cap}", file=sys.stderr)
    prog, first, state, over, counted = program_first(cell, prep, seed,
                                                      device)
    _free(device)
    epochs = max(2, round(seconds / cell.epoch_s))
    batches = -(-prep.arrays["item_ids"].shape[0] // law["batch"])
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
    examples = epochs * prep.arrays["item_ids"].shape[0]
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
            flops_per_example=counts.flops_per_example(m, law["t"]),
            needed_bytes_per_example=counts.needed_bytes_per_example(
                m, law["t"], law["batch"], prep.unique_share),
            pool_needed_bytes=counts.pool_needed_bytes(m, law["t"],
                                                       law["batch"]),
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


def _window(prog: Program, prep: Prepared, epochs: int, seed: int, state,
            batches: int, per_step: dict) -> Window:
    """One window's call; the trainer's result is dropped at once."""
    result, seconds, counted = prog.window(prep.arrays, epochs, seed, state)
    curve = result.loss_curve[len(state.loss_curve):]
    nonfinite = sum(1 for x in curve if not math.isfinite(x))
    steps = epochs * batches
    off = sum(abs(counted[k] - steps * per_step[k]) for k in counted)
    ran = [counted[k] / per_step[k] for k in counted if per_step[k] > 0]
    steps_run = int(min(ran)) if ran else len(curve) * batches
    print(f"window: {seconds:.3f} s; epochs (s): "
          f"{[round(x, 4) for x in result.epoch_times]}", file=sys.stderr)
    return Window(result.update_overflow_max, nonfinite, seconds,
                  abs(len(curve) - epochs), off, steps_run, counted)


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
