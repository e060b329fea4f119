"""K2 — cosine-gated DIN attention pool.

Port of goctr_tpu/ops/pallas/din_attention.py::din_attention_pool_pallas
(same math as the pool SparseCTR.apply_pooled computes inline):

    w_t  = (cos(behavior_t, item) + 1) / 2
    gate = sigmoid(w_t · att0_t) · mask_t
    out  = Σ_t gate_t · behavior_t / max(Σ_t mask_t, 1)

behaviors [B, T, D] and item [B, D] in float32 or bfloat16, att0 [T] and
mask [B, T] in float32 → [B, D] in the behaviors' dtype. All arithmetic is
float32 whatever the input dtype; only the output is rounded. The CUDA
kernel is csrc/din_attention.cu; `din_attention_pool_plain` is its plain
PyTorch version (cosine with the eps² norm clamp of cosine_similarity).

`din_attention_pool` launches the kernel for CUDA tensors and calls the
plain version for CPU tensors; on any other device, or when the kernel
cannot be built or launched, it raises. `din_attention_pool.launches`
counts kernel launches.

K2b is the pool's backward: `din_attention_pool_bwd` (kernel
csrc/din_attention_bwd.cu, plain version `din_attention_pool_bwd_plain`,
same routing, `din_attention_pool_bwd.launches`). `DinAttentionPool` is
the `torch.autograd.Function` that ties them: forward K2, backward K2b.
The JAX trainer differentiates the inline pool (no Pallas backward); the
plain backward writes that derivative out, with the eps² norm clamp of
cosine_similarity (a zero behavior row gets an exactly zero gradient
through its norm, never a NaN). K2b and its plain version work in float32
for bfloat16 inputs and in float64 for float32 inputs.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from goctr_tpu_torch.ops.activations import cosine_similarity
from goctr_tpu_torch.ops.kernels import _build

_NAME = "din_attention"
# (behaviors, item, att0, mask, out, batch, seq, dim, stream, n_sms)
_SIGNATURE = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int]
_ARGTYPES = {"din_attention_f32": _SIGNATURE,
             "din_attention_bf16": _SIGNATURE}
_BWD_NAME = "din_attention_bwd"
# (dout, behaviors, item, att0, mask, d_beh, d_item, d_att0, partial,
#  batch, seq, dim, stream, n_sms)
_BWD_SIGNATURE = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int]
_BWD_ARGTYPES = {"din_attention_bwd_f32": _BWD_SIGNATURE,
                 "din_attention_bwd_bf16": _BWD_SIGNATURE}
# the persistent grid (csrc/din_pool.cuh): WARPS_PER_BLOCK warps a block,
# at most BLOCKS_PER_SM blocks an SM; K2b's d_att0 partials take one float
# a t for each warp slot
WARPS_PER_BLOCK = 4                # kWarps
BLOCKS_PER_SM = 4                  # kBlocksPerSM
_count_lock = threading.Lock()
# the kernels' norm clamp: the float32 eps and eps² (plain K2b works in
# float64 on float32 inputs, with these float32 constants)
_EPS32 = float(torch.tensor(1e-8, dtype=torch.float32))
_EPS32_SQ = float(torch.tensor(1e-8, dtype=torch.float32) ** 2)


def sm_count(device: torch.device) -> int:
    """The card's SM count, which sizes the kernels' persistent grid."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def bwd_partial_floats(batch: int, seq: int, n_sms: int) -> int:
    """Floats of K2b's d_att0 partials: seq for each warp slot the grid can
    have (csrc/din_attention_bwd.cu takes min(BLOCKS_PER_SM · n_sms, the
    blocks its jobs need) blocks, and a job holds at least one row)."""
    blocks = min(BLOCKS_PER_SM * n_sms, -(-batch // WARPS_PER_BLOCK))
    return seq * WARPS_PER_BLOCK * blocks


def _check(behaviors, item, att0, mask) -> None:
    if behaviors.dim() != 3:
        raise ValueError(f"behaviors must be [B, T, D], got "
                         f"{tuple(behaviors.shape)}")
    b, t, d = behaviors.shape
    if behaviors.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"behaviors must be float32 or bfloat16, got "
                         f"{behaviors.dtype}")
    if item.shape != (b, d) or item.dtype != behaviors.dtype:
        raise ValueError(f"item must be [{b}, {d}] {behaviors.dtype}, got "
                         f"{tuple(item.shape)} {item.dtype}")
    if att0.shape != (t,) or att0.dtype != torch.float32:
        raise ValueError(f"att0 must be [{t}] float32")
    if mask.shape != (b, t) or mask.dtype != torch.float32:
        raise ValueError(f"mask must be [{b}, {t}] float32")
    for x in (item, att0, mask):
        if x.device != behaviors.device:
            raise ValueError("all inputs must be on one device")
    if not all(x.is_contiguous() for x in (behaviors, item, att0, mask)):
        raise ValueError("din_attention_pool inputs must be contiguous")


def din_attention_pool_plain(behaviors: torch.Tensor, item: torch.Tensor,
                             att0: torch.Tensor,
                             mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2 (f32 arithmetic, output in the
    behaviors' dtype)."""
    beh = behaviors.float()
    weight = (cosine_similarity(beh, item.float()[:, None, :]) + 1.0) * 0.5
    gate = torch.sigmoid(weight * att0) * mask
    pooled = (gate[..., None] * beh).sum(1)
    denom = torch.clamp(mask.sum(1, keepdim=True), min=1.0)
    return (pooled / denom).to(behaviors.dtype)


def din_attention_pool(behaviors: torch.Tensor, item: torch.Tensor,
                       att0: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """behaviors [B,T,D], item [B,D], att0 [T], mask [B,T] → [B,D]."""
    if mask is None:
        mask = torch.ones(behaviors.shape[:2], dtype=torch.float32,
                          device=behaviors.device)
    _check(behaviors, item, att0, mask)
    if behaviors.device.type == "cpu":
        return din_attention_pool_plain(behaviors, item, att0, mask)
    if behaviors.device.type != "cuda":
        raise ValueError(f"no din_attention kernel for {behaviors.device}")
    b, t, d = behaviors.shape
    out = torch.empty((b, d), dtype=behaviors.dtype,
                      device=behaviors.device)
    if b == 0:
        return out
    lib = _build.load(_NAME, _ARGTYPES)
    fn = lib.din_attention_bf16 if behaviors.dtype == torch.bfloat16 \
        else lib.din_attention_f32
    code = fn(behaviors.data_ptr(), item.data_ptr(), att0.data_ptr(),
              mask.data_ptr(), out.data_ptr(), b, t, d,
              torch.cuda.current_stream(behaviors.device).cuda_stream,
              sm_count(behaviors.device))
    _build.check(lib, _NAME, code)
    with _count_lock:
        din_attention_pool.launches += 1
    return out


din_attention_pool.launches = 0


def din_attention_pool_bwd_plain(dout: torch.Tensor,
                                 behaviors: torch.Tensor,
                                 item: torch.Tensor, att0: torch.Tensor,
                                 mask: torch.Tensor):
    """Plain PyTorch version of K2b: (d_behaviors, d_item) in the input
    dtype and d_att0 [T] float32 (the formulas are written out in
    csrc/din_attention_bwd.cu). Arithmetic is float32 for bfloat16 inputs
    and float64 for float32 inputs, as in the kernel: a zero item row's
    d_item is a sum over t of terms that cancel, which float32 rounding
    moves by ~1e-5 of itself; the clamps are the float32 eps and eps²."""
    wt = torch.float64 if behaviors.dtype == torch.float32 else torch.float32
    b = behaviors.to(wt)
    i = item.to(wt)[:, None, :]
    go = dout.to(wt)[:, None, :]
    eps, e2 = _EPS32, _EPS32_SQ
    att0, mask = att0.to(wt), mask.to(wt)
    bb = (b * b).sum(-1)                                   # [B, T]
    ii = (i * i).sum(-1)                                   # [B, 1]
    nb = torch.sqrt(torch.clamp(bb, min=e2))
    ni = torch.sqrt(torch.clamp(ii, min=e2))
    den = nb * ni + eps
    cos = (b * i).sum(-1) / den
    w = (cos + 1.0) * 0.5
    g = torch.sigmoid(w * att0)
    den_m = torch.clamp(mask.sum(1, keepdim=True), min=1.0)
    dz = (go * b).sum(-1) / den_m * mask * g * (1.0 - g)
    d_att0 = (dz * w).sum(0)
    dcos = dz * att0 * 0.5
    ddot = dcos / den
    dden = -dcos * cos / den
    cb = torch.where(bb > e2, dden * ni / nb, 0.0)
    ci = torch.where(ii > e2, (dden * nb).sum(1, keepdim=True) / ni, 0.0)
    d_b = ((g * mask / den_m)[..., None] * go + ddot[..., None] * i
           + cb[..., None] * b)
    d_i = (ddot[..., None] * b).sum(1) + ci * i[:, 0]
    return (d_b.to(behaviors.dtype), d_i.to(item.dtype),
            d_att0.to(torch.float32))


def din_attention_pool_bwd(dout: torch.Tensor, behaviors: torch.Tensor,
                           item: torch.Tensor, att0: torch.Tensor,
                           mask: torch.Tensor):
    """K2b: gradients of din_attention_pool's output `dout` [B, D] (in
    the behaviors' dtype) → (d_behaviors [B, T, D], d_item [B, D] in the
    input dtype, d_att0 [T] float32)."""
    _check(behaviors, item, att0, mask)
    b, t, d = behaviors.shape
    if dout.shape != (b, d) or dout.dtype != behaviors.dtype \
            or dout.device != behaviors.device:
        raise ValueError(f"dout must be [{b}, {d}] {behaviors.dtype} on "
                         f"{behaviors.device}, got {tuple(dout.shape)} "
                         f"{dout.dtype} on {dout.device}")
    if not dout.is_contiguous():
        raise ValueError("dout must be contiguous")
    if behaviors.device.type == "cpu":
        return din_attention_pool_bwd_plain(dout, behaviors, item, att0,
                                            mask)
    if behaviors.device.type != "cuda":
        raise ValueError(f"no din_attention_bwd kernel for "
                         f"{behaviors.device}")
    d_beh = torch.empty_like(behaviors)
    d_item = torch.empty_like(item)
    d_att0 = torch.empty(t, dtype=torch.float32, device=behaviors.device)
    if b == 0:
        return d_beh, d_item, d_att0.zero_()
    n_sms = sm_count(behaviors.device)
    partial = torch.empty(bwd_partial_floats(b, t, n_sms),
                          dtype=torch.float32, device=behaviors.device)
    lib = _build.load(_BWD_NAME, _BWD_ARGTYPES)
    fn = lib.din_attention_bwd_bf16 if behaviors.dtype == torch.bfloat16 \
        else lib.din_attention_bwd_f32
    code = fn(dout.data_ptr(), behaviors.data_ptr(), item.data_ptr(),
              att0.data_ptr(), mask.data_ptr(), d_beh.data_ptr(),
              d_item.data_ptr(), d_att0.data_ptr(), partial.data_ptr(),
              b, t, d, torch.cuda.current_stream(behaviors.device).cuda_stream,
              n_sms)
    _build.check(lib, _BWD_NAME, code)
    with _count_lock:
        din_attention_pool_bwd.launches += 1
    return d_beh, d_item, d_att0


din_attention_pool_bwd.launches = 0


class DinAttentionPool(torch.autograd.Function):
    """The pool with a gradient: forward K2, backward K2b (their plain
    versions on the CPU). mask takes no gradient; K2b computes all three
    gradients, and only those of inputs that need one are returned (the
    dense DIN's behaviors and item are data)."""

    @staticmethod
    def forward(ctx, behaviors, item, att0, mask):
        ctx.save_for_backward(behaviors, item, att0, mask)
        return din_attention_pool(behaviors, item, att0, mask)

    @staticmethod
    def backward(ctx, dout):
        behaviors, item, att0, mask = ctx.saved_tensors
        grads = din_attention_pool_bwd(
            dout.contiguous(), behaviors, item, att0, mask)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)
