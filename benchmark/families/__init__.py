"""Model families: what the harness needs of one architecture, behind one
interface, so that a new architecture enters the benchmark as new files.

A configuration (configs/<config>.json) names its family by the key
`family` and its plain reference by the key `reference` (a path from the
checkout's root); every other key of the file is the family's own.
`registry.Bench` loads `benchmark/families/<family>.py` and the reference
file by path from the benchmark's root, so that a copy of the benchmark
with one more family file runs that family. A family module provides:

  draw(config, law, seed, device) -> Inputs
      the traffic `law` (traffic/<traffic>.json; the harness reads its
      `batch`) drawn from the seed: host arrays under names of the
      family's own, the row count, the compaction cap and the share of
      a batch's ids that are distinct (both printed by the harness)
  initial(config, law, seed, device)
      the initial weights, drawn from the seed: the same whenever they
      are drawn again (the program's and the reference's start)
  control(config) -> (kind, precision)
      the control of `correct`: the precision below the configuration's
      that the reference computes in, and its name in control.py's lines
  Program(config, law, inputs, device)
      the system under test, driven as a user drives it:
        first_steps(arrays, weights, seed, calls) -> (Readings, state,
            overflow, launches): one call of the program a entry of
            `calls`, each of that many steps on the next rows; Readings
            with one loss a call; the state after the last call; the
            counted kernels' launches in the last call
        window(arrays, epochs, seed, state) -> Called: one timed call of
            `epochs` epochs over every row, resumed from `state`, which it
            leaves as it was
  counted_kernels() -> {name: wrapper}
      the wrappers whose `.launches` count the program's kernel launches
  warm_batches(config, law, inputs, seed, calls, device) -> [batch]
      the rows the program gives each step of first_steps, by its
      documented order, each batch a dict of device tensors
  flops_per_example(config, law), needed_bytes_per_example(config, law,
  inputs)
      the work an example needs, whatever implements it
  kernel_bytes(config, law) -> {name: bytes}
      the bytes a step needs in each group of kernels whose roofline a
      per-layer metric reads (TraceData.kernel_bytes)

The reference module provides

  first_steps(config, weights, batches, *, precision=None,
              half_batch=False) -> Readings
      one step a batch from `weights`, one loss a step; `precision` in
      place of the configuration's (control.py's control), `half_batch`
      the loss over each batch's first half (a planted fault)

and imports nothing of the program.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Inputs:
    """A cell's inputs: the draw on the host, and what the harness counts
    on it."""
    arrays: dict
    rows: int
    cap: int
    unique_share: float


@dataclasses.dataclass
class Readings:
    """What the first steps of training show: the losses (the program's
    one a call, the reference's one a step), each leaf's first gradient
    as the optimizer gets it, each leaf's change over the steps (norms
    in float64; the row-updated table is leaf "table")."""
    losses: list
    grad: dict
    change: dict


@dataclasses.dataclass
class Called:
    """What one window's call gave: the loss of each epoch it ran, each
    epoch's seconds, the update rows its cap dropped, its seconds and the
    counted kernels' launches in it."""
    losses: list
    epoch_times: list
    overflow: int
    seconds: float
    launches: dict


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))
