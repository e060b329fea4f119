"""The program's own spans of its newest trainer call, as the span readers
of metrics/ take them: `goctr_tpu_torch.core.profiling.spans()`, which
holds the spans of the newest `goctr.train` call (in a `--trace 1` run,
the last traced window: set-up and the untraced window run with spans
off and record nothing). A program without spans, or a store that holds
no trainer call, gives None, and the readers report nothing.

A stage's device ms runs from a timing event the program records on the
stream as the stage opens to one as it closes, so it includes any time
the card sat idle while the stage's launches were still pending.
"""
from __future__ import annotations

import math
from typing import Optional

CALL = "goctr.train"
STEP = "goctr.train.step"
# the call's fixed host work: outside its epochs, whatever their number
FIXED = ("goctr.train.upload", "goctr.train.resume", "goctr.train.return")


def newest_call() -> Optional[list]:
    """The newest trainer call's spans (its `goctr.train` span first), or
    None."""
    try:
        from goctr_tpu_torch.core import profiling
        spans = profiling.spans()
    except (ImportError, AttributeError):   # a program without spans
        return None
    if not spans or spans[0].name != CALL or spans[0].end_ns is None:
        return None
    return spans


def stage_ms(name: str) -> Optional[float]:
    """Mean device ms of the call's spans `name` (ms a step for a step's
    stage)."""
    spans = newest_call()
    ms = [s.device_ms for s in spans or () if s.name == name]
    return sum(ms) / len(ms) if ms else None


def step_periods_ms(spans: list) -> list:
    """Device ms of each step's period: from its start to the next step's
    start in its epoch, and an epoch's last step from its start to its
    end."""
    by_epoch: dict = {}
    for s in spans:
        if s.name == STEP:
            by_epoch.setdefault(s.parent, []).append(s)
    out = []
    for steps in by_epoch.values():
        out += [b.device_start_ms - a.device_start_ms
                for a, b in zip(steps, steps[1:])]
        out.append(steps[-1].device_ms)
    return out


def nearest_rank(values: list, q: float) -> float:
    """The q-quantile by the nearest rank: the ceil(q·n)-th smallest."""
    ranked = sorted(values)
    return ranked[max(1, math.ceil(q * len(ranked))) - 1]


def step_p95_ms() -> Optional[float]:
    spans = newest_call()
    periods = step_periods_ms(spans) if spans else []
    return nearest_rank(periods, 0.95) if periods else None


def call_fixed_pct() -> Optional[float]:
    """Host seconds of the call's upload, resume and return over the
    call's, × 100."""
    spans = newest_call()
    if not spans or spans[0].host_s <= 0:
        return None
    fixed = sum(s.host_s for s in spans if s.name in FIXED and s.parent == 0)
    return 100.0 * fixed / spans[0].host_s
