"""From a torch.profiler trace of the window to what the per-layer readers
read: device time by kernel, the device's busy time (the union of its
kernels' and copies' intervals), the idle gaps named by the host op that
was running, and the kernel classes of `kernels.json`.

A class's time is its kernels' mean time a launch times their launches:
where the class names one of the port's counted wrappers, the launches are
the wrappers' count over the window times the class's kernels a call (its
traced launches over the count, rounded), so that events the profiler
drops do not shorten it; elsewhere its traced launches. (One wrapper may
launch kernels of several names, such as K1's bfloat16 and float32
instances.)
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import re
from pathlib import Path
from typing import Optional

KERNELS_FILE = Path(__file__).resolve().parent / "kernels.json"
# the host span the harness records around the window's call
WINDOW_SPAN = "benchmark.window"


@dataclasses.dataclass
class Kernel:
    name: str
    us: float          # traced device time, all launches
    count: int         # traced launches


@dataclasses.dataclass
class Profile:
    kernels: dict          # name → Kernel
    busy_s: float
    gaps: list             # (seconds, host op) of each idle gap


def _device_type(ev) -> str:
    return str(ev.device_type()).rsplit(".", 1)[-1]


def reduce(prof) -> Profile:
    """The window's profile → kernels, busy time and idle gaps. The window
    is the host span named WINDOW_SPAN; a gap before the first or after
    the last device op inside it counts too."""
    events = prof.profiler.kineto_results.events()
    dev, host, span = [], [], None
    for ev in events:
        kind = _device_type(ev)
        if kind == "CUDA" and ev.name() != WINDOW_SPAN:
            dev.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                        ev.name()))
        elif kind == "CPU" and ev.duration_ns() > 0:
            if ev.name() == WINDOW_SPAN:
                span = (ev.start_ns(), ev.start_ns() + ev.duration_ns())
            host.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                         ev.name(), ev.start_thread_id()))
    kernels: dict = {}
    for s, e, name in dev:
        k = kernels.setdefault(name, Kernel(name, 0.0, 0))
        k.us += (e - s) / 1e3
        k.count += 1
    dev.sort()
    busy_ns, gaps_ns = 0, []
    cur_s = cur_e = None
    for s, e, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_ns += cur_e - cur_s
                gaps_ns.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_ns += cur_e - cur_s
    if span is not None and dev:
        gaps_ns = ([(span[0], dev[0][0])] if dev[0][0] > span[0] else []) \
            + gaps_ns + ([(cur_e, span[1])] if span[1] > cur_e else [])
    return Profile(kernels, busy_ns / 1e9, _name_gaps(gaps_ns, host))


def _name_gaps(gaps, host) -> list:
    """(seconds, name) of each gap: the innermost host op of the main
    thread that spans the gap's middle; "python" where only the window's
    own span does (the trainer's Python between ops), "host" where none
    does."""
    if not host:
        return [((e - s) / 1e9, "host") for s, e in gaps]
    threads: dict = {}
    for h in host:
        threads[h[3]] = threads.get(h[3], 0) + 1
    main = max(threads, key=threads.get)
    ops = sorted((s, e, n) for s, e, n, tid in host if tid == main)
    starts = [o[0] for o in ops]
    out = []
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "host"
        for j in range(i, max(i - 400, -1), -1):
            if ops[j][1] >= mid:
                name = "python" if ops[j][2] == WINDOW_SPAN else ops[j][2]
                break
        out.append(((e - s) / 1e9, name))
    return out


def load_classes(path: Path = KERNELS_FILE) -> dict:
    """{class: {"patterns": [regex], "counters": [wrapper name]}}; a
    kernel belongs to the first class, in file order, that matches it."""
    return json.loads(path.read_text())["classes"]


def classify(name: str, classes: dict) -> Optional[str]:
    for cls, spec in classes.items():
        if any(re.search(p, name) for p in spec["patterns"]):
            return cls
    return None


def _by_class(profile: Profile, classes: dict) -> dict:
    """{class: [Kernel]} of the traced kernels."""
    out: dict = {}
    for k in profile.kernels.values():
        out.setdefault(classify(k.name, classes), []).append(k)
    return out


def _launches(kernels: list, calls: int) -> tuple[int, int]:
    """(traced, expected) launches of a class's kernels: with `calls` of
    its wrappers, the expected count is the calls times the kernels a call
    (the traced count over the calls, rounded, at least 1)."""
    traced = sum(k.count for k in kernels)
    if not calls:
        return traced, traced
    return traced, max(1, round(traced / calls)) * calls


def _calls(classes: dict, cls: str, launches: dict) -> int:
    return sum(launches.get(c, 0) for c in classes[cls].get("counters", []))


def class_ms(profile: Profile, classes: dict, launches: dict,
             wanted) -> float:
    """Device ms over the window of the kernels of the classes `wanted`:
    each class's mean time a launch times its expected launches."""
    total = 0.0
    for cls, kernels in _by_class(profile, classes).items():
        if cls not in wanted:
            continue
        traced, expected = _launches(kernels, _calls(classes, cls,
                                                     launches))
        total += sum(k.us for k in kernels) / traced * expected / 1e3
    return total


def lost_events(profile: Profile, classes: dict, launches: dict) -> int:
    """Launches of counted kernels that the trace lacks."""
    lost = 0
    for cls, kernels in _by_class(profile, classes).items():
        if cls is not None:
            traced, expected = _launches(kernels, _calls(classes, cls,
                                                         launches))
            lost += max(0, expected - traced)
    return lost


def short_name(key: str) -> str:
    """A kernel's function name (`ns::name<...>(args)` → name) with the
    innermost functor it is instantiated with, if any; a copy or memset
    keeps its kind (frozen copy of goctr_tpu_torch/utils/timing.py
    `kernel_name`)."""
    if key.startswith("Mem"):
        return key.split(" (")[0]
    m = re.search(r"(\w+)[<(]", key)
    if not m:
        return key[:40]
    if re.fullmatch(r"[Kk]ernel\d*", m[1]):      # name it by what it runs
        inner = re.match(r"<\s*(\w+)", key[m.end() - 1:])
        return f"{m[1]} {inner[1][:60]}" if inner else m[1]
    functors = re.findall(r"\w*Functor\w*", key[m.end():])
    return f"{m[1]} {functors[-1]}" if functors else m[1]


def breakdown(profile: Profile, top: int = 10) -> dict:
    """The device ops that took most time and the idle gaps by host op,
    in seconds, each list at most `top` long."""
    ops: dict = {}
    for k in profile.kernels.values():
        n = short_name(k.name)
        ops[n] = ops.get(n, 0.0) + k.us / 1e6
    idle: dict = {}
    for sec, name in profile.gaps:
        idle[name] = idle.get(name, 0.0) + sec
    by = lambda d: sorted(([k, v] for k, v in d.items()),
                          key=lambda kv: -kv[1])[:top]
    return {"device_ops": by(ops), "idle_gaps": by(idle)}


def unclassified(profile: Profile, classes: dict, top: int = 5) -> list:
    """[(seconds, short name)] of the kernels no class matches."""
    rows = [(k.us / 1e6, short_name(k.name)) for k in
            profile.kernels.values() if classify(k.name, classes) is None]
    return sorted(rows, reverse=True)[:top]
