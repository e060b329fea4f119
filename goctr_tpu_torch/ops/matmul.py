"""The tower's product in the JAX dtype policy: compute-dtype operands,
a float32 result (`jnp.dot(..., preferred_element_type=float32)`).

A bf16 product has no PyTorch derivative, so `matmul_f32` goes through an
autograd Function with the backward JAX computes for `dot(x_bf16, w_bf16,
preferred_element_type=f32)` (read from its jaxpr): dx = bf16(g · wᵀ),
dw = bf16(xᵀ · g), both products in float32 from the float32 cotangent
g. The weight's `.to(bf16)` then widens dw back to float32, as JAX's
`astype(cd)` does. These are plain matmuls, left to cuBLAS on the card
(with TF32 off) as JAX leaves them to XLA. SparseCTR and the dense
rankers (models/) share it.
"""
from __future__ import annotations

import torch


class _MatmulF32(torch.autograd.Function):
    """bf16 × bf16 → f32 product with JAX's backward (module docstring).
    On the card `torch.mm(..., out_dtype=float32)` (f32 accumulation, no
    bf16 rounding of the result). The CPU has no such overload; there the
    operands are widened first, which gives the same product, since a
    product of two bf16 values is exact in float32."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        if h.is_cuda:
            return torch.mm(h, w, out_dtype=torch.float32)
        return h.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = (g @ w.float().t()).to(h.dtype)
        if ctx.needs_input_grad[1]:
            dw = (h.float().t() @ g).to(w.dtype)
        return dh, dw


def matmul_f32(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h @ w with a float32 result from compute-dtype operands."""
    if h.dtype == torch.float32:
        return h @ w
    return _MatmulF32.apply(h, w)
