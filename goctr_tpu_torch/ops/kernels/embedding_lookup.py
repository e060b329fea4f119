"""K3 — fused gather + sum/mean pool over the K ids of each batch row.

Port of goctr_tpu/ops/pallas/embedding_lookup.py: the forward of
`fused_gather_pool_pallas` / `fused_gather_pool_jnp` (:85-122) and the
custom VJP `gather_pool_mean` (:146-178). The CUDA kernel is
csrc/gather_pool.cu; `fused_gather_pool_plain` is its plain PyTorch
version.

table [V, D] float32 and ids [B, K] int32 (-1 = pad) give [B, D] float32:

    sum:  out[b] = sum over k with ids[b, k] >= 0 of table[ids[b, k]]
    mean: that / max(count of ids[b, k] >= 0, 1)

the semantics of `fused_gather_pool_jnp`, which JAX runs at the trainer's
shapes: a fully padded row gives 0, and an id >= V adds a NaN row (the
fill of `jnp.take`, and what K1 returns for it) while counting as valid.

With `offsets`, a [F + 1] int32 tensor of column offsets on the ids'
device (0 = offsets[0] <= ... <= offsets[F] = K), each row holds F bags,
bag f in columns offsets[f] .. offsets[f+1] - 1, and the result is
[B, F, D] float32: out[b, f] pools bag f of row b as above (DLRM's
multi-hot features, each sum-pooled, in one launch). The kernel pools
each bag as it pools a row, so without offsets (F = 1) its arithmetic is
the one-bag pool's; the offsets' values are not checked on the card
(that would wait on it).
The TPU kernel's gates (D % 128 == 0, B % 8 == 0, K >= 8) are Mosaic
tiling limits; the port takes any B, any K and any D.

`fused_gather_pool` launches the kernel for CUDA tensors and calls the
plain version for CPU tensors; on any other device, or when the kernel
cannot be built or launched, it raises. `fused_gather_pool.launches`
counts kernel launches.

`bag_row_grads` spreads the gradient of a multi-bag sum pool back to
each id's row, the stream a sparse row update takes (the table never
enters autograd there).

`GatherPoolMean` is the counterpart of `gather_pool_mean`: forward K3
with "mean", backward the closed form of `_gather_pool_mean_bwd` — each
valid position's row gets g[b] / count[b], added into a [V, D] gradient
(ids past the table are dropped). JAX computes that backward in XLA, not
in a Pallas kernel, so it stays torch glue here (`index_add_`); on the
card `index_add_` adds a hot id's rows with atomics, in an order that is
not fixed from run to run.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from goctr_tpu_torch.ops.kernels import _build

_NAME = "gather_pool"
# (table, ids, out, batch, k, n_rows, dim, mean, offsets, n_feat, stream)
_ARGTYPES = {"gather_pool_f32": [ctypes.c_void_p] * 3
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p]}
COMBINERS = ("sum", "mean")
_count_lock = threading.Lock()


def _check(table: torch.Tensor, ids: torch.Tensor, combiner: str,
           offsets: torch.Tensor | None = None) -> None:
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}, got "
                         f"{combiner!r}")
    if table.dim() != 2 or table.dtype != torch.float32:
        raise ValueError(f"table must be a 2-D float32 tensor, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if table.shape[1] < 1:
        raise ValueError(f"emb dim {table.shape[1]} must be at least 1")
    if ids.dim() != 2 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be a 2-D int32 tensor, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    if ids.device != table.device:
        raise ValueError(f"ids on {ids.device}, table on {table.device}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("table and ids must be contiguous")
    if offsets is not None and (
            offsets.dim() != 1 or offsets.shape[0] < 2
            or offsets.dtype != torch.int32 or offsets.device != ids.device
            or not offsets.is_contiguous()):
        raise ValueError(f"offsets must be a contiguous [F + 1] int32 "
                         f"tensor on {ids.device}, got "
                         f"{tuple(offsets.shape)} {offsets.dtype} on "
                         f"{offsets.device}")


def fused_gather_pool_plain(table: torch.Tensor, ids: torch.Tensor,
                            combiner: str = "sum",
                            offsets: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Plain PyTorch version of K3 (`fused_gather_pool_jnp`'s steps, then
    with `offsets` one sum a bag)."""
    _check(table, ids, combiner, offsets)
    b, k = ids.shape
    v, d = table.shape
    flat = ids.reshape(-1).long()
    in_table = (flat >= 0) & (flat < v)
    rows = table.index_select(0, torch.where(in_table, flat, 0))
    rows = rows.masked_fill((~in_table & (flat >= 0))[:, None],
                            float("nan"))
    valid = (ids >= 0).to(torch.float32)
    rows = rows.view(b, k, d) * valid[..., None]
    if offsets is None:
        pooled = rows.sum(1)
        count = valid.sum(1, keepdim=True)
    else:
        off = offsets.tolist()
        if off[0] != 0 or off[-1] != k or any(
                a > c for a, c in zip(off, off[1:])):
            raise ValueError(f"offsets {off} must rise from 0 to K = {k}")
        pooled = torch.stack([rows[:, a:c].sum(1)
                              for a, c in zip(off, off[1:])], 1)
        count = torch.stack([valid[:, a:c].sum(1)
                             for a, c in zip(off, off[1:])], 1)[..., None]
    if combiner == "mean":
        pooled = pooled / count.clamp_min(1.0)
    return pooled


def fused_gather_pool(table: torch.Tensor, ids: torch.Tensor,
                      combiner: str = "sum",
                      offsets: torch.Tensor | None = None) -> torch.Tensor:
    """Pool the rows of `table` at `ids` ([B, K] int32, -1 pads) → [B, D]
    float32, or with `offsets` ([F + 1] int32) each row's F bags →
    [B, F, D] (module docstring), by `combiner` ("sum" or "mean")."""
    _check(table, ids, combiner, offsets)
    if table.device.type == "cpu":
        return fused_gather_pool_plain(table, ids, combiner, offsets)
    if table.device.type != "cuda":
        raise ValueError(f"no gather_pool kernel for {table.device}")
    b, k = ids.shape
    v, d = table.shape
    shape = (b, d) if offsets is None else (b, offsets.shape[0] - 1, d)
    out = torch.empty(shape, dtype=torch.float32, device=table.device)
    if b == 0:
        return out
    lib = _build.load(_NAME, _ARGTYPES)
    code = lib.gather_pool_f32(
        table.data_ptr(), ids.data_ptr(), out.data_ptr(), b, k, v, d,
        int(combiner == "mean"),
        None if offsets is None else offsets.data_ptr(),
        1 if offsets is None else offsets.shape[0] - 1,
        torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(lib, _NAME, code)
    with _count_lock:
        fused_gather_pool.launches += 1
    return out


fused_gather_pool.launches = 0


def table_grad(ids: torch.Tensor, rows: torch.Tensor,
               n_rows: int) -> torch.Tensor:
    """A table's gradient [n_rows, D] from row gradients: rows[..., :] added
    at ids[...] (`index_add_`), ids outside [0, n_rows) dropped (the
    transpose of `jnp.take`; they go to one extra row, cut off)."""
    d = rows.shape[-1]
    flat = ids.reshape(-1).long()
    flat = torch.where((flat >= 0) & (flat < n_rows), flat, n_rows)
    out = rows.new_zeros((n_rows + 1, d)).index_add_(0, flat,
                                                     rows.reshape(-1, d))
    return out[:n_rows]


def bag_row_grads(g: torch.Tensor, col_feature: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """The row gradients of a sum pool over F bags a row: g [B, F, D], the
    pooled rows' gradient, → [B·K, D] in `dtype`, row b·K + k holding
    g[b, col_feature[k]] (col_feature [K] int64, each column's bag),
    rounded to `dtype` once (a cast of the [B, F, D] rows, then one
    gather). This is the id stream's gradient that a sparse row update
    takes, in the order of the [B, K] ids."""
    d = g.shape[-1]
    return g.to(dtype).index_select(1, col_feature).reshape(-1, d)


def gather_pool_mean_bwd(g: torch.Tensor, ids: torch.Tensor,
                         n_rows: int) -> torch.Tensor:
    """The table's gradient [n_rows, D] of the mean pool for the pooled
    rows' gradient g [B, D] (`_gather_pool_mean_bwd`): g[b] / count[b] at
    each valid id of row b, ids past the table dropped."""
    valid = (ids >= 0).to(g.dtype)
    count = valid.sum(1, keepdim=True).clamp_min(1.0)
    return table_grad(ids, (g / count)[:, None, :] * valid[..., None],
                      n_rows)


class GatherPoolMean(torch.autograd.Function):
    """Trainable mean-pool lookup: table [V, D], ids [B, K] → [B, D];
    forward K3, backward `gather_pool_mean_bwd` (module docstring)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return fused_gather_pool(table, ids, "mean")

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return gather_pool_mean_bwd(g, ids, ctx.n_rows), None


def gather_pool_mean(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return GatherPoolMean.apply(table, ids)
