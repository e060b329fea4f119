"""Plain reference of DLRM-DCNv2's first training steps in PyTorch (the
`dlrm_dcnv2` family's; families/__init__.py has the interface), written
from the model's published description and importing nothing of the
program.

The model (MLPerf Training recommendation_v2/torchrec_dlrm; DLRM,
arXiv:1906.00091; DCN-V2, arXiv:2008.13535): a bottom MLP over the dense
features with ReLU on every layer; each sparse feature's bag of ids
sum-pooled from the feature's own table; x0 = [bottom | pooled_0 | ... ];
a low-rank cross net, x_{l+1} = x0 ⊙ (W_l (V_l x_l) + b_l) + x_l; a top
MLP with ReLU between its layers and a linear last one; the mean sigmoid
cross-entropy of the logit. A step takes the gradient of the loss with
respect to the dense leaves and to every pooled row, applies adagrad to
each dense leaf (optax's scale_by_rss from 0, then -lr: θ -= lr · g /
sqrt(Σg² + eps), no step where Σg² is 0; or, with the trainer's solver
"sgd", θ -= lr · g), spreads each pooled row's
gradient to every id of its bag, and applies row-wise adagrad to each
distinct row's summed gradient G: acc += ‖G‖², w -= lr · G /
sqrt(acc + eps).

Departures from the published model, each shared with the program: the
tables hold this card's rows of a feature (the configuration's cut:
ids drawn over the held rows; the all-to-all of the 8-card job is absent
here and in the program alike); the tables are one [V, D] table, feature
f's rows after those of features 0 .. f - 1, so an id is offset by its
feature's first row; the learning rates are constant (MLPerf warms up and
decays them); row-wise adagrad adds ‖G‖² summed over the D lanes, where
FBGEMM's EXACT_ROWWISE_ADAGRAD (MLPerf's) adds its mean over D, so acc is
D times larger and a table step 1/sqrt(D) of FBGEMM's at the same lr
(1/11.3 at D = 128); the loss is taken in one batch, with no gradient
all-reduce.

Arithmetic is float32 (TF32 off). `precision` is the compute dtype the
configuration states: the values it says are held in that dtype (the
dense features, the weights each product reads, each layer's output, the
pooled rows, the cross net's rank projection) are rounded to it, and so
are the gradients that flow back through them, each once, after every
use has added its share in float32; the table, the dense leaves, the
optimizers' state and every sum stay float32. Each id's share of its
bag's gradient is the pooled row's gradient as rounded there.
"float32" rounds nothing. "float8_e4m3" (with a per-tensor scale) is the
control. `half_batch` takes the loss over the first half of each batch
only: a planted fault. The dense part runs in blocks of BLOCK rows
(gradients summed over the blocks; a float8 scale is taken a block), so
that the reference fits beside the program's state on the card.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from benchmark.families import Readings, norm

FP8_MAX = 448.0          # largest finite float8 e4m3 value
BLOCK = 8192             # rows of a batch in one autograd pass


def rounding(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """x (float32) → x rounded to `precision`, in float32."""
    if precision == "float32":
        return lambda x: x
    if precision == "bfloat16":
        return lambda x: x.to(torch.bfloat16).float()
    if precision == "float8_e4m3":
        def fp8(x):
            amax = x.detach().abs().max()
            scale = torch.where(amax > 0, FP8_MAX / amax, 1.0)
            return (x * scale).to(torch.float8_e4m3fn).float() / scale
        return fp8
    raise ValueError(f"unknown precision {precision!r}")


class _Round(torch.autograd.Function):
    """Rounds the value forward and its gradient backward."""

    @staticmethod
    def forward(ctx, x, q):
        ctx.q = q
        return q(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.q(g), None


def layers(config: dict) -> dict:
    """The model's widths from the configuration's keys (MLPerf's
    torchrec_dlrm arguments) and each feature's held rows."""
    rows = list(config["num_embeddings_per_feature"])
    for k, v in config.items():
        if k.startswith("rows_f"):
            rows[int(k[len("rows_f"):])] = v
    over = list(config["over_arch_layer_sizes"])
    return {"dense": config["dense_in_features"],
            "dim": config["embedding_dim"],
            "hotness": list(config["multi_hot_sizes"]), "rows": rows,
            "bottom": list(config["dense_arch_layer_sizes"]),
            "cross_layers": config["dcn_num_layers"],
            "cross_rank": config["dcn_low_rank_dim"], "top": over[:-1],
            "compute_dtype": config["compute_dtype"]}


def pool(w: torch.Tensor, pos: torch.Tensor, hotness: list) -> torch.Tensor:
    """[B, F, D]: each bag's rows of w, at the positions pos [B, K] of its
    columns, summed column by column."""
    out = w.new_zeros((pos.shape[0], len(hotness), w.shape[1]))
    k = 0
    for f, h in enumerate(hotness):
        for _ in range(h):
            out[:, f] += w[pos[:, k]]
            k += 1
    return out


def logits(p: dict, dense: torch.Tensor, pooled: torch.Tensor, q,
           lay: dict) -> torch.Tensor:
    """Logits [B] from dense leaves p (by name), the dense features
    [B, 13] and the pooled rows [B, F, D]."""
    r = lambda x: _Round.apply(x, q)
    h = q(dense)
    for i in range(len(lay["bottom"])):
        h = r(torch.relu(h @ r(p[f"bottom_w.{i}"]) + p[f"bottom_b.{i}"]))
    x0 = torch.cat([h, r(pooled.reshape(pooled.shape[0], -1))], 1)
    x = x0
    for i in range(lay["cross_layers"]):
        u = r(r(x) @ r(p[f"cross_v.{i}"]))
        x = r(x0 * (u @ r(p[f"cross_w.{i}"]) + p[f"cross_b.{i}"]) + x)
    n = len(lay["top"]) + 1
    for i in range(n):
        x = r(x) @ r(p[f"top_w.{i}"]) + p[f"top_b.{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return x[:, 0]


def bce(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Σ of the sigmoid cross-entropy terms."""
    return (torch.clamp(z, min=0) - z * y
            + torch.log1p(torch.exp(-torch.abs(z)))).sum()


class Steps(NamedTuple):
    """The state after the steps: the losses (one a step), each leaf's
    first gradient norm, the dense leaves by name, the touched rows (their
    ids, ascending), their weights and their accumulators."""
    losses: list
    grad: dict
    params: dict
    touched: torch.Tensor
    rows: torch.Tensor
    acc: torch.Tensor


def first_steps(config: dict, weights, batches: list, *,
                precision: Optional[str] = None,
                half_batch: bool = False) -> Readings:
    """Train from weights = (dense leaves by name, table [V, D]) over
    `batches` (dicts of device tensors: dense, ids (each feature's own),
    labels), one step each, and read the steps (one loss a step), at
    `precision` (by default the configuration's compute dtype). Only the
    rows the batches touch are held and updated."""
    dense0, table0 = weights
    st = steps(config, weights, batches, precision=precision,
               half_batch=half_batch)
    change = {k: norm(st.params[k] - dense0[k]) for k in st.params}
    change["table"] = norm(st.rows - table0.index_select(0, st.touched))
    return Readings(st.losses, st.grad, change)


def steps(config: dict, weights, batches: list, *,
          precision: Optional[str] = None, half_batch: bool = False
          ) -> Steps:
    """`first_steps`' training, its state returned whole."""
    dense0, table0 = weights
    prev_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        lay = layers(config)
        q = rounding(precision or lay["compute_dtype"])
        return _steps(lay, config["trainer"], config["table_opt"], dense0,
                      table0, batches, q, half_batch)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev_tf32


def _steps(lay, train, table_opt, dense0, table0, batches, q,
           half_batch) -> Steps:
    dev = table0.device
    hot = lay["hotness"]
    lr, eps = train["lr"], train["epsilon"]
    t_lr, t_eps = table_opt["lr"], table_opt["eps"]
    first_row = torch.cumsum(torch.tensor([0] + lay["rows"][:-1],
                                          device=dev), 0)
    col_base = torch.repeat_interleave(first_row,
                                       torch.tensor(hot, device=dev))
    col_feat = [f for f, h in enumerate(hot) for _ in range(h)]
    ids = [b["ids"].long() + col_base for b in batches]
    touched = torch.unique(torch.cat([x.reshape(-1) for x in ids]))
    w = table0.index_select(0, touched).clone()
    acc = torch.zeros(touched.numel(), dtype=torch.float64, device=dev)
    p = {k: v.clone() for k, v in dense0.items()}
    sos = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad = [], {}
    for step, (b, ids_b) in enumerate(zip(batches, ids), 1):
        bs = ids_b.shape[0]
        keep = bs // 2 if half_batch else bs
        pos = torch.searchsorted(touched, ids_b)
        pooled = pool(w, pos, hot)
        leaves = {k: x.detach().requires_grad_() for k, x in p.items()}
        g = {k: torch.zeros_like(x) for k, x in p.items()}
        g_pooled = torch.zeros_like(pooled)
        loss = 0.0
        for s in range(0, keep, BLOCK):
            e = min(s + BLOCK, keep)
            blk = pooled[s:e].detach().requires_grad_()
            z = logits(leaves, b["dense"][s:e], blk, q, lay)
            part = bce(z, b["labels"][s:e]) / keep
            gs = torch.autograd.grad(part, list(leaves.values()) + [blk])
            for k, gk in zip(leaves, gs[:-1]):
                g[k] += gk
            g_pooled[s:e] = gs[-1]
            loss += float(part.detach())
        losses.append(loss)
        for k, x in p.items():
            if step == 1:
                grad[k] = norm(g[k])
            if train["solver"] == "sgd":
                p[k] = x - lr * g[k]
                continue
            sos[k] = g[k] * g[k] + sos[k]
            scale = torch.where(sos[k] > 0, torch.rsqrt(sos[k] + eps), 0.0)
            p[k] = x - lr * (scale * g[k])
        big_g = torch.zeros_like(w)
        for k in range(ids_b.shape[1]):       # each id's share of its bag's
            big_g.index_add_(0, pos[:, k], g_pooled[:, col_feat[k]])
        if step == 1:
            grad["table"] = norm(big_g)
        acc += (big_g.double() ** 2).sum(1)
        w = w - t_lr * big_g * torch.rsqrt(acc + t_eps).float()[:, None]
    return Steps(losses, grad, p, touched, w, acc.float())
