"""The comparison that decides `correct`, the same for every family: the
program's first three steps against the plain reference's over the same
inputs, and each window's work against what it was asked.

  loss_gap           the largest relative gap of a set-up call's loss
                     (step 1's; the mean of steps 2-3's, which the
                     trainer runs as one call and reports as one loss)
  grad_gap           the worst leaf's gap between the program's and the
                     reference's norm of the first gradient as the
                     optimizer got it, over the larger of the reference's
                     norm of that leaf and of the median leaf
  change_median_gap  the median dense leaf's gap, measured alike, of each
                     leaf's change over the three steps, leaving out
                     leaves whose first gradient in the reference is
                     under a thousandth of the median leaf's (they move
                     by round-off alone)
  change_table_gap   the item table's gap, measured alike, of its change
                     over the three steps: the row update on the
                     configuration's own path
  overflow           update rows the compaction cap dropped in any call
  nonfinite          epochs of a window whose loss is not finite
  epochs_off         epochs a window ran fewer or more than it was asked
  launches_off       launches of the port's counted kernels in a window
                     off from its steps × their launches a step in
                     steps 2-3

The dense change is held by its median leaf, not its worst: adam moves
every element of a leaf by about lr whatever its gradient's size, so an
element whose first gradient lies within summation-order rounding of 0
moves either way, and the worst dense leaf's gap (`change_worst_gap`,
reported but not compared) swings from seed to seed by 2-6× on the card.
The table's adagrad step scales with its gradient, so it is held alone.

The first four are held to the cell's limits (cells/<cell>.json); the
rest to 0.
"""
from __future__ import annotations

import math
import statistics

from benchmark.families import Readings

# leaves whose reference gradient is under this share of the median leaf's
# are left out of the change numbers
NOUGHT_SHARE = 1e-3
# the item table's leaf in Readings
TABLE = "table"


def _leaf_gaps(prog: dict, ref: dict, leaves) -> list:
    med = statistics.median(ref[k] for k in leaves)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves]


def numbers(prog: Readings, ref: Readings) -> dict:
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(prog.losses, ref.losses))
    med_g = statistics.median(ref.grad.values())
    moving = [k for k in ref.grad if ref.grad[k] >= NOUGHT_SHARE * med_g]
    change = dict(zip(moving, _leaf_gaps(prog.change, ref.change, moving)))
    dense = [v for k, v in change.items() if k != TABLE]
    return {"loss_gap": loss,
            "grad_gap": max(_leaf_gaps(prog.grad, ref.grad, list(ref.grad))),
            "change_median_gap": statistics.median(dense),
            "change_table_gap": change.get(TABLE, math.nan),
            "change_worst_gap": max(dense)}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}); a number that is missing or
    not finite fails."""
    checks = {k: {"value": values.get(k, math.nan), "limit": lim}
              for k, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
