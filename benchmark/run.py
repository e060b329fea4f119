"""Run one cell of BENCHMARK.json on this machine's card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints the card's name and power limit, then, as the last line of
standard output, one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics; with --trace 1 its per-layer metrics),
device, with --trace 1 breakdown, and last `checks`, each number compared
with its limit (also the last lines of standard error). Exits nonzero,
printing no result, without a CUDA card (or fewer than the cell asks
for) or if jax, jaxlib, flax or goctr_tpu is loaded once the window has
closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# caches of the run at fixed paths inside the checkout (the port builds its
# kernels into goctr_tpu_torch/_build by itself)
CACHE = ROOT / ".bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "goctr_tpu")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout else out.stderr


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import run_cell
    from benchmark.registry import Bench

    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    dev = torch.device("cuda", 0)
    line, epochs, values = run_cell(bench, cell, args.seed, args.seconds,
                                    bool(args.trace), dev, T_START)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"benchmark: the run loaded {loaded}", file=sys.stderr)
        return 3
    print(f"window: {epochs} epochs, {line['attempted']} steps",
          file=sys.stderr)
    print(f"not compared: change_worst_gap {values['change_worst_gap']!r}",
          file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
