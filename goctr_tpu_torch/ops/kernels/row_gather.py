"""K1 — row gather by id over the plain, packed and grouped table layouts.

Port of goctr_tpu/ops/pallas/row_gather.py::gather_rows_packed (and of the
`rows_of` gathers of goctr_tpu/serve/scorer.py:88-99). The CUDA kernel is
csrc/row_gather.cu; `gather_rows_plain` is its plain PyTorch version.

`gather_rows` launches the kernel for a CUDA table and calls the plain
version for a CPU table; on any other device, or when the kernel cannot be
built or launched, it raises. `gather_rows.launches` counts kernel
launches (plain calls do not count), and `gather_rows.launches_by_dim`
counts them by row width, which tells the call sites of one path apart
(a trainer's forward gather at D, its row update's read at 128).

Layout parameters: `group` rows per line (1 for plain and packed, G for
grouped lines) and `dim` weight lanes per row (default: the table's width
for group 1). Row r lives in line r // group at lanes
(r % group)·(dim+1) … +dim. Ids outside [0, lines·group) give NaN rows.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from goctr_tpu_torch.ops.kernels import _build

_NAME = "row_gather"
# (table, ids, out, n, n_rows, stride, group, dim, stream)
_SIGNATURE = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_ARGTYPES = {"row_gather_f32": _SIGNATURE, "row_gather_bf16": _SIGNATURE}
_count_lock = threading.Lock()
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _layout(table: torch.Tensor, group: int, dim: int | None) -> int:
    if table.dim() != 2 or table.dtype != torch.float32:
        raise ValueError(f"table must be a 2-D float32 tensor, got "
                         f"{tuple(table.shape)} {table.dtype}")
    stride = table.shape[1]
    if dim is None:
        if group != 1:
            raise ValueError("dim is required for a grouped table")
        dim = stride
    span = dim if group == 1 else group * (dim + 1)
    if group < 1 or dim < 1 or span > stride:
        raise ValueError(f"group={group}, dim={dim} do not fit a line of "
                         f"{stride} lanes")
    return dim


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor, *,
                      group: int = 1, dim: int | None = None,
                      out_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """Plain PyTorch version of K1: [..ids] → [..ids, dim] in out_dtype."""
    dim = _layout(table, group, dim)
    flat = ids.reshape(-1).long()
    valid = (flat >= 0) & (flat < table.shape[0] * group)
    safe = torch.where(valid, flat, torch.zeros_like(flat))
    lines = table.index_select(0, torch.div(safe, group,
                                            rounding_mode="floor"))
    cols = ((safe % group)[:, None] * (dim + 1)
            + torch.arange(dim, device=table.device))
    rows = lines.gather(1, cols).masked_fill(~valid[:, None], float("nan"))
    return rows.to(out_dtype).reshape(*ids.shape, dim)


def gather_rows(table: torch.Tensor, ids: torch.Tensor, *, group: int = 1,
                dim: int | None = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gather rows of `table` by `ids` (int32) into [..ids, dim]."""
    dim = _layout(table, group, dim)
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    if ids.device != table.device:
        raise ValueError(f"ids on {ids.device}, table on {table.device}")
    if ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32, got {ids.dtype}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("table and ids must be contiguous")
    if table.device.type == "cpu":
        return gather_rows_plain(table, ids, group=group, dim=dim,
                                 out_dtype=out_dtype)
    if table.device.type != "cuda":
        raise ValueError(f"no row_gather kernel for {table.device}")
    n = ids.numel()
    out = torch.empty((n, dim), dtype=out_dtype, device=table.device)
    if n == 0:
        return out.reshape(*ids.shape, dim)
    lib = _build.load(_NAME, _ARGTYPES)
    fn = lib.row_gather_bf16 if out_dtype == torch.bfloat16 \
        else lib.row_gather_f32
    code = fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(), n,
              table.shape[0] * group, table.shape[1], group, dim,
              torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(lib, _NAME, code)
    with _count_lock:
        gather_rows.launches += 1
        by_dim = gather_rows.launches_by_dim
        by_dim[dim] = by_dim.get(dim, 0) + 1
    return out.reshape(*ids.shape, dim)


gather_rows.launches = 0
gather_rows.launches_by_dim = {}
