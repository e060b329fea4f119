"""HTTP serving throughput of the port: the full round trip through
RecApiServer (the counterpart of the JAX repository's
scripts/bench_serving.py, with its fixture, flags and two printed lines).

    python3 -m goctr_tpu_torch.bench_serving [--cpu] [--requests=50]
                                             [--items=400] [--threads=4]

The reference's serving path (api.go:106-131): POST /api/v1/recommend
with {userId, itemIdList[items]} → the scored list. A fixture database
(200 users × 500 movies × 12,000 ratings, seed 7), MovielensRec(
sample_cnt=12000) and an MLP trained by Train (batch 256, 3 epochs, lr
3e-3) on the card, then `--threads` concurrent clients send `--requests`
POSTs after one warm request: scores/s over the HTTP stack (JSON decode →
feature assembly → the model's predict → JSON encode). Runs on the card
unless given --cpu; without a card and without --cpu it exits nonzero.
"""
from __future__ import annotations

import json
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

FIXTURE = dict(n_users=200, n_movies=500, n_ratings=12000, seed=7)
FLAGS = ("requests", "items", "threads")         # run's integer arguments


def run(requests: int = 50, items: int = 400, threads: int = 4,
        device: str | torch.device = "cuda") -> dict:
    """Train the fixture's ranker on `device`, serve it on a free port and
    time `requests` POSTs of `items` candidates from `threads` clients.
    Returns the readings: scores, seconds, requests, items, threads and
    the device's type."""
    from goctr_tpu_torch.data.fixture import generate_movielens_fixture
    from goctr_tpu_torch.data.movielens import MovielensRec
    from goctr_tpu_torch.models.trainer import TrainerConfig
    from goctr_tpu_torch.recommend import Context, RankerFitter, Train
    from goctr_tpu_torch.serve.api import RecApiServer

    dev = torch.device(device)
    with tempfile.TemporaryDirectory() as tmp:
        db = str(Path(tmp) / "ml.db")
        generate_movielens_fixture(db, **FIXTURE)
        rec = MovielensRec(db, sample_cnt=12000)
        predictor = Train(Context(), rec, RankerFitter(
            "mlp", TrainerConfig(batch_size=256, epochs=3, early_stop=0,
                                 lr=3e-3), device=dev), device=dev)
        server = RecApiServer(predictor, host="127.0.0.1", port=0).start(
            background=True)
        try:
            url = f"http://127.0.0.1:{server.port}/api/v1/recommend"
            body = list(range(1, items + 1))

            def one(uid: int) -> int:
                req = urllib.request.Request(
                    url, data=json.dumps({"userId": 1 + uid % 100,
                                          "itemIdList": body}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req) as r:
                    return len(json.loads(r.read())["itemScoreList"])

            one(0)                              # warm (first calls, caches)
            t0 = time.perf_counter()
            with ThreadPoolExecutor(threads) as pool:
                total = sum(pool.map(one, range(requests)))
            dt = time.perf_counter() - t0
        finally:
            server.stop()
    return {"backend": dev.type, "threads": threads, "requests": requests,
            "items": items, "scores": total, "seconds": dt}


def lines(r: dict) -> list[str]:
    """The JAX script's two lines for the readings of `run`."""
    dt = r["seconds"]
    return [f"backend={r['backend']} threads={r['threads']} "
            f"requests={r['requests']} items/req={r['items']}",
            f"HTTP serving: {r['scores']} scores / {dt:.2f}s = "
            f"{r['scores'] / dt:.0f} scores/s ({r['requests'] / dt:.1f} "
            f"req/s)"]


def main(argv: list[str]) -> int:
    kw = {}
    for a in argv:
        name, _, value = a[2:].partition("=")
        if a == "--cpu":
            continue
        if not a.startswith("--") or name not in FLAGS or not value:
            raise SystemExit(f"bench_serving: unknown argument {a!r}")
        kw[name] = int(value)
    cpu = "--cpu" in argv
    if not cpu and not torch.cuda.is_available():
        print("bench_serving: torch.cuda.is_available() is False; pass "
              "--cpu to run on the CPU", file=sys.stderr)
        return 2
    for line in lines(run(**kw, device="cpu" if cpu else "cuda")):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
