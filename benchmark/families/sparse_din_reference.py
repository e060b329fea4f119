"""Plain reference of the sparse DIN ranker's first training steps in
PyTorch (the `sparse_din` family's; families/__init__.py has the
interface), written from the model's description and importing nothing of
the program.

The model (Zhou et al., arXiv:1706.06978, as go-ctr implements it): each
id's row of an item table [V, D]; a gated attention pool over the T
behavior rows,

    w_t = (cos(b_t, item) + 1) / 2,  gate_t = sigmoid(w_t · att0_t) · mask_t,
    pooled = Σ_t gate_t · b_t / max(Σ_t mask_t, 1)

(cosine over norms clamped below at eps, eps in the denominator); a relu
tower over [profile | pooled | item | ctx] to one logit; the mean
sigmoid cross-entropy. A step takes the gradient of the loss with
respect to the dense leaves and to every gathered row, adds l2 · θ to
each dense gradient and takes an adam step (optax's formulas, bias
corrected), and applies row-wise adagrad to each distinct id's summed
row gradient G: acc += ‖G‖², w -= lr · G / sqrt(acc + eps).

Arithmetic is float32 (TF32 off). `precision` is the compute dtype the
configuration states: the values it says are held in that dtype (the
gathered rows, the pooled rows, the tower's inputs, weights and hidden
activations) are rounded to it, and so are the gradients that flow back
through them; the table, the dense leaves, the optimizers' state and
every sum stay float32. "float32" rounds nothing. "float8_e4m3" (with a
per-tensor scale) is the control: the step below bfloat16 that a later
change could be tempted by. `half_batch` takes the loss over the first
half of each batch only: a planted fault.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from benchmark.families import Readings, norm

FP8_MAX = 448.0          # largest finite float8 e4m3 value


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


def din_pool(beh: torch.Tensor, item: torch.Tensor, att0: torch.Tensor,
             mask: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    dot = (beh * item[:, None, :]).sum(-1)
    nb = torch.sqrt(torch.clamp((beh * beh).sum(-1), min=eps * eps))
    ni = torch.sqrt(torch.clamp((item * item).sum(-1, keepdim=True),
                                min=eps * eps))
    cos = dot / (nb * ni + eps)
    gate = torch.sigmoid((cos + 1.0) * 0.5 * att0) * mask
    return ((gate[..., None] * beh).sum(1)
            / torch.clamp(mask.sum(1, keepdim=True), min=1.0))


def logits(p: dict, rows_b, rows_i, profile, ctx, q) -> torch.Tensor:
    """Logits [B] from dense leaves p, behavior rows [B, T, D], item rows
    [B, D], profile [B, U] and ctx [B, C]."""
    r = lambda x: _Round.apply(x, q)
    beh, item = r(rows_b), r(rows_i)
    mask = torch.ones(beh.shape[:2], device=beh.device)
    pooled = r(din_pool(beh, item, p["att0"], mask))
    h = torch.cat([q(profile), pooled, item, q(ctx)], 1)
    n = sum(1 for k in p if k.startswith("mlp."))
    for i in range(n):
        h = h @ r(p[f"mlp.{i}"]) + p[f"bias.{i}"]
        if i < n - 1:
            h = r(torch.relu(h))
    return h[:, 0]


def bce(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(z, min=0) - z * y
            + torch.log1p(torch.exp(-torch.abs(z)))).mean()


def first_steps(config: dict, weights, batches: list, *,
                precision: Optional[str] = None,
                half_batch: bool = False) -> Readings:
    """Train from weights = (dense leaves, table [V, D]) over `batches`
    (dicts of device tensors: user_profile, behavior_ids, item_ids, ctx,
    labels), one step each, and read the steps (one loss a step), at
    `precision` (by default the configuration's compute dtype). Only the
    rows the batches touch are held and updated."""
    dense0, table0 = weights
    model, train = config["model"], config["trainer"]
    prev_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        q = rounding(precision or model["compute_dtype"])
        return _first_steps(model, train, config["table_opt"], dense0,
                            table0, batches, q, half_batch)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev_tf32


def _first_steps(model, train, table_opt, dense0, table0, batches, q,
                 half_batch) -> Readings:
    d = model["emb_dim"]
    b1, b2, eps = train["beta1"], train["beta2"], train["epsilon"]
    lr, l2 = train["lr"], train["l2"]
    t_lr, t_eps = table_opt["lr"], table_opt["eps"]
    ids = [torch.cat([b["behavior_ids"].reshape(-1), b["item_ids"]]).long()
           for b in batches]
    touched = torch.unique(torch.cat(ids))
    w = table0.index_select(0, touched).clone()
    acc = torch.zeros(touched.numel(), dtype=torch.float64,
                      device=w.device)
    p = {k: v.clone() for k, v in dense0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad = [], {}
    for step, (b, ids_b) in enumerate(zip(batches, ids), 1):
        bs, t = b["behavior_ids"].shape
        pos = torch.searchsorted(touched, ids_b)
        rows = w.index_select(0, pos).requires_grad_()
        leaves = {k: x.detach().requires_grad_() for k, x in p.items()}
        z = logits(leaves, rows[:bs * t].view(bs, t, d), rows[bs * t:],
                   b["user_profile"], b["ctx"], q)
        keep = bs // 2 if half_batch else bs
        loss = bce(z[:keep], b["labels"][:keep])
        g = torch.autograd.grad(loss, list(leaves.values()) + [rows])
        losses.append(float(loss.detach()))
        for (k, x), gk in zip(p.items(), g[:-1]):
            gk = gk + l2 * x
            if step == 1:
                grad[k] = norm(gk)
            m[k] = b1 * m[k] + (1 - b1) * gk
            v2[k] = b2 * v2[k] + (1 - b2) * gk * gk
            mh = m[k] / (1 - b1 ** step)
            vh = v2[k] / (1 - b2 ** step)
            p[k] = x - lr * mh / (torch.sqrt(vh) + eps)
        big_g = torch.zeros_like(w).index_add_(0, pos, g[-1])
        if step == 1:
            grad["table"] = norm(big_g)
        acc += (big_g.double() ** 2).sum(1)
        w = w - t_lr * big_g * torch.rsqrt(acc + t_eps).float()[:, None]
    change = {k: norm(p[k] - dense0[k]) for k in p}
    change["table"] = norm(w - table0.index_select(0, touched))
    return Readings(losses, grad, change)
