"""Activations and similarity ops (port of goctr_tpu/ops/activations.py).

Parity targets: reference model/activation.go (PRelu32:10-16,
EucDistance:18-50, CosineSimilarity:52-85) and the sklearn-port
activation table (nn/neural_network/basemlp64.go:79-117).
"""
from __future__ import annotations

import torch


def identity(x):
    return x


def logistic(x):
    return torch.sigmoid(x)


def relu(x):
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)


def softmax(x):
    return torch.softmax(x, dim=-1)


# name → fn, matching sklearn/reference activation strings
ACTIVATIONS = {
    "identity": identity,
    "logistic": logistic,
    "sigmoid": logistic,
    "relu": relu,
    "tanh": tanh,
    "softmax": softmax,
}


def prelu(x: torch.Tensor, slope) -> torch.Tensor:
    """Learnable leaky-relu (reference PRelu32 activation.go:10-16):
    0.5*((x - |x|)*slope + (x + |x|))."""
    return 0.5 * ((x - x.abs()) * slope + (x + x.abs()))


def cosine_similarity(x: torch.Tensor, y: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
    """Cosine similarity over the last axis with broadcasting
    (reference CosineSimilarity activation.go:52-85).

    x: [..., T, D], y: [..., 1, D] (or equal shapes) → [..., T].

    Norms are clamped below at eps² BEFORE the sqrt: d/dx sqrt(Σx²) is
    0/0 = NaN at an exactly-zero row, and zero rows are routine (padding
    positions), so the clamp gives them exact zero gradients; values for
    any non-degenerate row are unchanged. eps² is formed in the working
    dtype, as the JAX version forms it.
    """
    dot = (x * y).sum(-1)
    e2 = torch.tensor(eps, dtype=dot.dtype) ** 2
    xn = torch.sqrt(torch.clamp((x * x).sum(-1), min=e2.item()))
    yn = torch.sqrt(torch.clamp((y * y).sum(-1), min=e2.item()))
    return dot / (xn * yn + eps)


def euclidean_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """L2 distance over the last axis with broadcasting
    (reference EucDistance activation.go:18-50)."""
    d = x - y
    return torch.sqrt((d * d).sum(-1))
