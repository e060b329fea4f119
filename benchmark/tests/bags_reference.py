"""The bags family's reference (tests/bags_family.py), written a second time
by hand: each bag's rows summed by indexing, the log-loss's gradient
worked out in closed form, the table's gathered back by index_add."""
from __future__ import annotations

from typing import Optional

import torch

from benchmark.families import Readings, norm

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def first_steps(config: dict, weights: dict, batches: list, *,
                precision: Optional[str] = None,
                half_batch: bool = False) -> Readings:
    dt = DTYPES[precision or config["model"]["dtype"]]
    lr, d = config["sgd"]["lr"], config["model"]["dim"]
    p = {k: v.to(dt) for k, v in weights.items()}
    losses, grad = [], {}
    for b in batches:
        n = b["labels"].shape[0] // 2 if half_batch else b["labels"].shape[0]
        ids, x, y = b["bags"][:n], b["dense"][:n].to(dt), b["labels"][:n].to(dt)
        h = torch.cat([p["table"][ids].sum(1), x], 1)
        z = h @ p["w"] + p["b"]
        losses.append(float((torch.logaddexp(torch.zeros_like(z), z)
                             - y * z).double().mean()))
        dz = (torch.sigmoid(z) - y) / n
        g = {"w": h.T @ dz, "b": dz.sum(0, keepdim=True),
             "table": torch.zeros_like(p["table"]).index_add_(
                 0, ids.reshape(-1),
                 (dz[:, None] * p["w"][:d]).repeat_interleave(ids.shape[1],
                                                              0))}
        grad = grad or {k: norm(v) for k, v in g.items()}
        p = {k: v - lr * g[k] for k, v in p.items()}
    change = {k: norm(p[k] - weights[k].to(dt)) for k in p}
    return Readings(losses, grad, change)
