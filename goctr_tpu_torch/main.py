"""goctr_tpu_torch CLI: train the MovieLens ranker on the card and serve
the scoring API (port of the JAX package's main.py).

Mirrors the reference binary (main.go:23-57): build MovielensRec → train
MLP (hidden [100], relu, adam, α=1e-5) → serve on :8080. Config via
dotted overrides, e.g.:

    python -m goctr_tpu_torch.main --data.dsn=movielens.db \
        --model.name=din --optim.max_iter=50 --serve.port=8080
    python -m goctr_tpu_torch.main --fixture   # write a synthetic db first

item2vec and the fit run on the card; `main(argv, device=...)` takes
another device from Python (the tests pass "cpu"), and the CLI has no
flag for it.
"""
from __future__ import annotations

import logging
import sys

import torch

from goctr_tpu_torch.core.config import Config


def main(argv: list[str], *, device: str | torch.device = "cuda") -> int:
    cfg = Config()
    rest = cfg.apply_overrides(argv)
    logging.basicConfig(
        level=logging.DEBUG if cfg.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    log = logging.getLogger("goctr")

    if "--fixture" in rest:
        from goctr_tpu_torch.data.fixture import generate_movielens_fixture
        generate_movielens_fixture(cfg.data.dsn)
        log.info("wrote synthetic fixture to %s", cfg.data.dsn)
        if rest == ["--fixture"]:
            return 0

    from goctr_tpu_torch.data.movielens import MovielensRec
    from goctr_tpu_torch.models.trainer import TrainerConfig
    from goctr_tpu_torch.recommend import Context, RankerFitter, Train
    from goctr_tpu_torch.serve.api import RecApiServer

    rec = MovielensRec(cfg.data.dsn, sample_cnt=80000)
    tc = TrainerConfig(
        batch_size=cfg.optim.batch_size, epochs=cfg.optim.max_iter,
        early_stop=cfg.optim.early_stop_patience, solver=cfg.optim.solver,
        lr=cfg.optim.lr, lr_schedule=cfg.optim.lr_schedule,
        l2=cfg.optim.alpha, weight_decay=cfg.optim.weight_decay,
        seed=cfg.seed, verbose=cfg.verbose)
    model_kw = {}
    if cfg.model.name == "mlp":
        model_kw = dict(hidden=tuple(cfg.model.hidden),
                        activation=cfg.model.activation)
    fitter = RankerFitter(cfg.model.name, tc, use_bf16=cfg.model.use_bf16,
                          device=device, **model_kw)

    log.info("training %s on %s ...", cfg.model.name, cfg.data.dsn)
    predictor = Train(Context(), rec, fitter, device=device)
    log.info("training done; serving on %s:%d%s", cfg.serve.host,
             cfg.serve.port, cfg.serve.api_path)
    RecApiServer(predictor, api_path=cfg.serve.api_path,
                 host=cfg.serve.host, port=cfg.serve.port).start()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
