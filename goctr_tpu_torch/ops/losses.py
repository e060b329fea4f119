"""Training losses (port of goctr_tpu/ops/losses.py).

The reference trains probability-space BCE on sigmoid outputs with a 1e-8
fudge inside log(1-p) (model/cost.go:7-18). The models keep logits until
the loss, so training uses the numerically stable `bce_with_logits`
(`bce_loss` is its weighted mean, which the trainers use to mask pad
rows); `binary_cross_entropy` exists for probability-space parity checks.
Every loss computes in float32 and returns a 0-d float32 tensor.
"""
from __future__ import annotations

import torch


def binary_cross_entropy(y_pred: torch.Tensor, y_true: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    """-mean(y*log(p) + (1-y)*log(1+eps-p)); reference BinaryCrossEntropy32."""
    y_pred, y_true = y_pred.float(), y_true.float()
    pos = torch.log(torch.clamp(y_pred, min=1e-12)) * y_true
    neg = torch.log(torch.clamp(1.0 + eps - y_pred, min=1e-12)) * (
        1.0 - y_true)
    return -torch.mean(pos + neg)


def _bce_terms(logits: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """max(z,0) - z*y + log1p(exp(-|z|)), elementwise."""
    return (torch.clamp(logits, min=0) - logits * y_true
            + torch.log1p(torch.exp(-torch.abs(logits))))


def bce_with_logits(logits: torch.Tensor,
                    y_true: torch.Tensor) -> torch.Tensor:
    """Stable sigmoid cross-entropy, the mean over all entries."""
    return torch.mean(_bce_terms(logits.float(), y_true.float()))


def bce_loss(logits: torch.Tensor, y: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """Weighted mean of the stable BCE-with-logits: Σ l·w / max(Σ w, 1)
    (the JAX trainers' loss, goctr_tpu/models/trainer.py:223-227). Pad
    rows carry w = 0."""
    return (_bce_terms(logits, y) * w).sum() / torch.clamp(w.sum(), min=1.0)


def mse(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """Reference MSE32 cost.go:21-24."""
    d = y_pred.float() - y_true.float()
    return torch.mean(d * d)


def rms(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """Reference RMS32 cost.go:27-30."""
    return torch.sqrt(mse(y_pred, y_true))
