"""Packed embedding-table layouts and the split row update (port of
goctr_tpu/ops/pallas/row_optimizer.py: LANES and ROWS_PER_STEP :47-48,
pack/unpack :238-262, grouped lines :470-558, the split update and its
write-only scatter :768-867, pack_grads :904-911).

Two layouts, bit for bit the JAX package's, so a table packed by one
package unpacks in the other:

  * packed   [V, 128] f32 — one row per line: `w (D lanes) | acc | 0-pad`;
  * grouped  [ceil(V/G), 128] f32 — G = 128 // (D+1) rows per line, row r
    in line r // G at lanes (r % G)·(D+1) … +D (weights) and +D (acc);
    lanes past G·(D+1), and rows past the vocab in the last line, are 0.

The JAX package places lanes with 0/1 matmuls (a TPU tiling workaround);
here the lanes are written directly, which gives the same bits.

The split row update (`apply_row_updates_split`, rmw_impl="split") reads
the targeted packed rows with kernel K1, applies row adagrad or sgd in
torch, and writes the rows back with kernel K4 (`scatter_rows_packed`,
csrc/row_scatter.cu). Unlike the JAX functions, which return a new array,
both update the table IN PLACE and return it: a [10M, 128] table is
5.1 GB. On one stream the read finishes before K4 writes, and the rows K4
writes are a fresh tensor, never a view of the table.
`scatter_rows_packed` launches K4 for CUDA tensors and calls its plain
version for CPU tensors; on any other device, or when the kernel cannot
be built or launched, it raises. `scatter_rows_packed.launches` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from goctr_tpu_torch.ops.kernels import _build
from goctr_tpu_torch.ops.kernels.row_gather import gather_rows

LANES = 128
# update rows per grid step of the JAX kernels; the trainer pads its
# update stream to a multiple of it, as the JAX trainer does
ROWS_PER_STEP = 1024
_SCATTER = "row_scatter"
# (table, ids, rows, n, skip_ge, stream)
_SCATTER_ARGTYPES = {"row_scatter": [ctypes.c_void_p] * 3
                     + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]}
_count_lock = threading.Lock()


def pack_table(weights: torch.Tensor, acc: torch.Tensor | None = None
               ) -> torch.Tensor:
    """[V, D] weights (+ optional [V] adagrad acc) → packed [V, 128] f32."""
    v, d = weights.shape
    if d >= LANES:
        raise ValueError(f"emb dim {d} leaves no accumulator lane")
    packed = torch.zeros((v, LANES), dtype=torch.float32,
                         device=weights.device)
    packed[:, :d] = weights
    if acc is not None:
        packed[:, d] = acc
    return packed


def unpack_table(table_packed: torch.Tensor, d: int):
    """packed [V, 128] → ([V, D] weights, [V] acc) views."""
    return table_packed[:, :d], table_packed[:, d]


def group_size(d: int) -> int:
    """Rows per 128-lane line in the grouped layout."""
    return max(1, LANES // (d + 1))


def packed_lines(vocab: int, d: int) -> int:
    return -(-vocab // group_size(d))


def pack_table_grouped(weights: torch.Tensor,
                       acc: torch.Tensor | None = None) -> torch.Tensor:
    """[V, D] (+ [V] acc) → [ceil(V/G), 128] grouped lines."""
    v, d = weights.shape
    g = group_size(d)
    if g == 1:
        return pack_table(weights, acc)
    lines = packed_lines(v, d)
    grid = torch.zeros((lines * g, d + 1), dtype=torch.float32,
                       device=weights.device)
    grid[:v, :d] = weights
    if acc is not None:
        grid[:v, d] = acc
    out = torch.zeros((lines, LANES), dtype=torch.float32,
                      device=weights.device)
    out[:, :g * (d + 1)] = grid.reshape(lines, g * (d + 1))
    return out


def unpack_table_grouped(table_lines: torch.Tensor, vocab: int, d: int):
    """grouped [L, 128] → ([vocab, D] weights, [vocab] acc)."""
    g = group_size(d)
    if g == 1:
        w, acc = unpack_table(table_lines, d)
        return w[:vocab], acc[:vocab]
    lines = table_lines.shape[0]
    arr = table_lines[:, :g * (d + 1)].reshape(lines * g, d + 1)
    return arr[:vocab, :d], arr[:vocab, d]


def unpack_table_grouped_np(table_lines: np.ndarray, vocab: int, d: int):
    """Host (numpy) unpack: the export path for grouped tables."""
    g = group_size(d)
    lines = table_lines.shape[0]
    arr = np.asarray(table_lines)[:, :g * (d + 1)].reshape(lines, g, d + 1)
    w = arr[:, :, :d].reshape(lines * g, d)[:vocab]
    acc = np.ascontiguousarray(arr[:, :, d].reshape(lines * g)[:vocab])
    return w, acc


def init_packed_table_grouped(generator: torch.Generator, vocab: int,
                              d: int, scale: float = 0.01) -> torch.Tensor:
    """Fresh grouped table N(0, scale²) on the weight lanes, zeros
    elsewhere, drawn straight into line layout on the generator's device
    (no [V, D] intermediate: 100M × 16 is 7.3 GB of lines)."""
    g = group_size(d)
    lines = packed_lines(vocab, d)
    stride = d + 1
    table = torch.randn((lines, LANES), generator=generator,
                        dtype=torch.float32, device=generator.device)
    lane = torch.arange(LANES, device=table.device)
    live = (lane < g * stride) & ((lane % stride) < d)
    table.mul_(scale).masked_fill_(~live, 0.0)
    tail = lines * g - vocab               # pad rows in the last line
    if tail:
        table[-1, (g - tail) * stride:] = 0.0
    return table


def _check_scatter(table: torch.Tensor, ids: torch.Tensor,
                   rows: torch.Tensor, skip_ge: int) -> None:
    if table.dim() != 2 or table.shape[1] != LANES \
            or table.dtype != torch.float32:
        raise ValueError(f"table must be [V, {LANES}] float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be [n] int32, got {tuple(ids.shape)} "
                         f"{ids.dtype}")
    if rows.shape != (ids.shape[0], LANES) or rows.dtype != torch.float32:
        raise ValueError(f"rows must be [{ids.shape[0]}, {LANES}] float32, "
                         f"got {tuple(rows.shape)} {rows.dtype}")
    if ids.device != table.device or rows.device != table.device:
        raise ValueError("table, ids and rows must be on one device")
    if not (table.is_contiguous() and ids.is_contiguous()
            and rows.is_contiguous()):
        raise ValueError("table, ids and rows must be contiguous")
    if not 0 <= skip_ge <= table.shape[0]:
        raise ValueError(f"skip_ge={skip_ge} must lie in [0, "
                         f"{table.shape[0]}]")
    t0 = table.data_ptr()
    t1 = t0 + table.numel() * 4
    r0 = rows.data_ptr()
    if rows.numel() and r0 < t1 and t0 < r0 + rows.numel() * 4:
        raise ValueError("rows must not alias the table")


def scatter_rows_packed_plain(table: torch.Tensor, ids: torch.Tensor,
                              rows: torch.Tensor,
                              skip_ge: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K4: table[ids[j]] = rows[j] for
    0 <= ids[j] < skip_ge, in place (`index_put_` of the real rows)."""
    if skip_ge is None:
        skip_ge = table.shape[0]
    real = (ids >= 0) & (ids < skip_ge)
    table.index_put_((ids[real].long(),), rows[real])
    return table


def scatter_rows_packed(table: torch.Tensor, ids: torch.Tensor,
                        rows: torch.Tensor,
                        skip_ge: int | None = None) -> torch.Tensor:
    """table[ids[j]] = rows[j] for pairwise-distinct ids < skip_ge, in
    place; rows with ids >= skip_ge (junk targets, which may point past
    the table) or < 0 are skipped. table [V, 128] f32, ids [n] int32,
    rows [n, 128] f32. Returns the table."""
    if skip_ge is None:
        skip_ge = table.shape[0]
    _check_scatter(table, ids, rows, skip_ge)
    if table.device.type == "cpu":
        return scatter_rows_packed_plain(table, ids, rows, skip_ge)
    if table.device.type != "cuda":
        raise ValueError(f"no row_scatter kernel for {table.device}")
    n = ids.shape[0]
    if n == 0:
        return table
    lib = _build.load(_SCATTER, _SCATTER_ARGTYPES)
    code = lib.row_scatter(table.data_ptr(), ids.data_ptr(), rows.data_ptr(),
                           n, skip_ge,
                           torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(lib, _SCATTER, code)
    with _count_lock:
        scatter_rows_packed.launches += 1
    return table


scatter_rows_packed.launches = 0


def pack_grads(g: torch.Tensor) -> torch.Tensor:
    """[n, D] row gradients → [n, 128] (g | ‖g‖² | 0) f32 update rows."""
    n, d = g.shape
    gp = torch.zeros((n, LANES), dtype=torch.float32, device=g.device)
    gp[:, :d] = g
    gp[:, d] = (g * g).sum(1)
    return gp


def updated_rows(table: torch.Tensor, ids: torch.Tensor,
                 g_packed: torch.Tensor, lr: float, d: int,
                 kind: str = "adagrad", eps: float = 1e-8) -> torch.Tensor:
    """The new packed rows of `ids` ([n, 128] f32, a fresh tensor): read
    the current rows (K1; junk ids past the table read row V − 1) and
    apply DLRM row-wise adagrad

        acc' = acc + ‖g‖²,   w' = w − lr · g · rsqrt(acc' + eps)

    or sgd (w' = w − lr · g) in float32, term by term as the JAX
    apply_row_updates_split does. g_packed [n, 128] is (g | ‖g‖² | 0)."""
    if kind not in ("adagrad", "sgd"):
        raise ValueError(f"unknown row optimizer {kind!r}")
    lane = torch.arange(LANES, device=table.device)
    m_w = (lane < d).float()
    m_acc = (lane == d).float()
    cur = gather_rows(table, ids.clamp(max=table.shape[0] - 1), dim=LANES)
    if kind == "adagrad":
        r_acc = cur + g_packed * m_acc
        scale = lr * torch.rsqrt(r_acc[:, d:d + 1] + eps)
        return r_acc - scale * (g_packed * m_w)
    return cur - lr * (g_packed * m_w)


def apply_row_updates_split(table: torch.Tensor, ids: torch.Tensor,
                            g_packed: torch.Tensor, lr: float, d: int,
                            kind: str = "adagrad", eps: float = 1e-8,
                            skip_ge: int | None = None) -> torch.Tensor:
    """Split row update on the packed [V, 128] table, in place: the rows
    of `updated_rows`, written back with K4. ids [n] int32 pairwise
    distinct below skip_ge (junk targets past it are skipped)."""
    new = updated_rows(table, ids, g_packed, lr, d, kind, eps)
    return scatter_rows_packed(table, ids, new, skip_ge=skip_ge)
