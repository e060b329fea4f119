"""Readings that set a cell's limits (cells/<cell>.json), at the cell's own
size on the card; the benchmark's runs do not run this.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 ...
        [--control-seeds 1 2 3]

For each of --seeds: the program's first three steps (set-up's two
calls, as a run makes them) against the reference's (check.py's
numbers: the lower readings). For each of
--control-seeds: in the program's place, the reference computed in the
precision below the configuration's (the control; the family's
`control`: for sparse_din's bfloat16, float8 e4m3 with a per-tensor
scale, kind "float8"), and the reference with half of each batch
left out and the mean taken over the rest (a planted fault). A step that
returns its state unchanged reads 1 on change_median_gap and
change_table_gap by construction and is not run. Prints one JSON line a reading.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(bench, name: str, seeds, control_seeds, device, out=print):
    import gc

    import torch

    from benchmark import check, harness

    cell = bench.cell(name)
    control_kind, precision = cell.family.control(cell.config)
    rows = []
    for seed in list(seeds) + [s for s in control_seeds if s not in seeds]:
        t0 = time.perf_counter()
        prep = harness.prepare(cell, seed, device)
        ref = harness.reference_first(cell, prep, seed, device)
        kinds = {}
        if seed in seeds:
            _, first, state, over, _ = harness.program_first(
                cell, prep, seed, device)
            del state
            gc.collect()
            kinds["program"] = (first, over)
        if seed in control_seeds:
            kinds[control_kind] = (harness.reference_first(
                cell, prep, seed, device, precision=precision), 0)
            kinds["half_batch"] = (harness.reference_first(
                cell, prep, seed, device, half_batch=True), 0)
        for kind, (r, over) in kinds.items():
            row = {"cell": name, "seed": seed, "kind": kind,
                   **check.numbers(r, ref), "overflow": over,
                   "losses": r.losses, "ref_losses": ref.losses,
                   "grad": r.grad, "ref_grad": ref.grad,
                   "change": r.change, "ref_change": ref.change,
                   "seconds": time.perf_counter() - t0}
            rows.append(row)
            out(json.dumps(row))
        del prep
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    import torch

    from benchmark.registry import Bench

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    readings(Bench(ROOT), args.workload, args.seeds, args.control_seeds,
             torch.device("cuda", 0), lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
