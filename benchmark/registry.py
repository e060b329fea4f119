"""Finds what a cell needs by the names in BENCHMARK.json:

  configs/<config>.json     the configuration (the file BENCHMARK.json
                            names for it), which names its family and its
                            reference
  families/<family>.py      the family's draw, weights, program and counts
                            (families/__init__.py has the interface)
  <reference>               the file the configuration's `reference`
                            names, from the checkout's root
  traffic/<traffic>.json    the traffic mix, read by the family's draw
  cells/<cell>.json         the cell's limits on the numbers compared, and
                            its epoch time on the card (`epoch_s`)
  metrics/<metric>.py       a per-layer metric's reader: read(t) → a
                            number, or None where it finds nothing

A new family, configuration, traffic mix, cell or metric is a new file
and a new entry in BENCHMARK.json; nothing here changes. Families,
references and readers load by path from the Bench's root, so that a
copy of the benchmark with files added runs them.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    family: ModuleType     # families/<family>.py
    reference: ModuleType  # the configuration's reference
    traffic: dict
    limits: dict           # number compared → its limit
    epoch_s: float         # an epoch's seconds on the card, which sets E
    end_to_end: list       # the BENCHMARK.json entries this cell reports
    per_layer: list


class Bench:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        check_names(self.spec)
        self._modules: dict = {}

    def _in_cell(self, metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def cell(self, name: str) -> Cell:
        by_name = {w["name"]: w for w in self.spec["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = by_name[name]
        cfg_entry = {c["name"]: c for c in self.spec["configs"]}[w["config"]]
        bench_dir = self.root / "benchmark"
        cell_file = _json(bench_dir / "cells" / f"{name}.json")
        config = _json(self.root / cfg_entry["file"])
        return Cell(
            name=name, chips=w["chips"], config=config,
            family=self.family(config.get("family"), w["config"]),
            reference=self.module(self.root / config["reference"]),
            traffic=_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
            limits=cell_file["limits"], epoch_s=cell_file["epoch_s"],
            end_to_end=[m for m in self.spec["end_to_end"]
                        if self._in_cell(m, name)],
            per_layer=[m for m in self.spec["per_layer"]
                       if self._in_cell(m, name)])

    def reader(self, metric: str):
        """The `read` function of metrics/<metric>.py."""
        return self.module(
            self.root / "benchmark" / "metrics" / f"{metric}.py").read

    def family(self, name, config: str = "") -> ModuleType:
        """families/<name>.py; a name with no such file fails here."""
        path = self.root / "benchmark" / "families" / f"{name}.py"
        if not isinstance(name, str) or not NAME.match(name) \
                or not path.is_file():
            raise ValueError(
                f"configuration {config!r} names the family {name!r}, which "
                f"has no file benchmark/families/{name}.py")
        return self.module(path)

    def module(self, path: Path) -> ModuleType:
        """The Python file at `path`, loaded once a Bench, under a name of
        its own in sys.modules (a dataclass looks its module up there)."""
        path = Path(path).resolve()
        if path not in self._modules:
            name = "benchmark_file_" + hashlib.sha256(
                str(path).encode()).hexdigest()[:16]
            spec = importlib.util.spec_from_file_location(name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return self._modules[path]


def _json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def check_names(spec: dict) -> None:
    """Names and units as the benchmark's contract allows them."""
    names = [c["name"] for c in spec["configs"]]
    names += [w["name"] for w in spec["workloads"]]
    names += [w[k] for w in spec["workloads"] for k in ("config", "traffic")]
    names += [k for c in spec["configs"] for k in c["reduced"]]
    metrics = spec["end_to_end"] + spec["per_layer"]
    names += [m["name"] for m in metrics]
    bad = [n for n in names if not NAME.match(n)]
    bad += [m["unit"] for m in metrics if not UNIT.match(m["unit"])]
    if bad:
        raise ValueError(f"names or units outside the allowed letters: {bad}")
    for group in (spec["configs"], spec["workloads"], metrics):
        seen = [x["name"] for x in group]
        if len(seen) != len(set(seen)):
            raise ValueError(f"a name appears twice: {seen}")
