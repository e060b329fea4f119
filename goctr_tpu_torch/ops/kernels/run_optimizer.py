"""K8 — the sorted-run row update of the packed [V, 128] table.

Port of goctr_tpu/ops/pallas/run_optimizer.py (ID_MASK and pack_meta
:56-62, :199-206, apply_run_updates :209-269, its jnp fallback
:272-301), the table update of update_mode="runfused". Given ids sorted
ascending with their duplicates still in (each duplicate's gradient row
separate), each run of an id in [0, skip_ge) is summed and its line gets
one row-wise adagrad or sgd update:

    acc' = acc + ‖Σg‖²,  w' = w − lr · Σg · rsqrt(acc' + eps)
    (sgd: w' = w − lr · Σg)

The CUDA kernel is csrc/run_rmw.cu: it sums runs across 128-row tiles
with a segmented carry scan, as K9 does, and writes only table lines and
per-tile carries; its tile pass streams the rows through a ring of bulk
copies. `apply_run_updates_plain` is its plain PyTorch version, the JAX
fallback's arithmetic: run sums as differences of cumsum rows
(`sorted_run_sums`), then `apply_run_sums`. The JAX kernel sums each run
in position order, the CUDA kernel in tile order and the plain version
by cumsum differences, so the three agree to f32 rounding of the sums.

`apply_run_updates` launches the kernel for CUDA tensors and calls the
plain version for CPU tensors; on any other device, or when the kernel
cannot be built or launched, it raises. It updates the table IN PLACE
(the JAX function returns a new array). `apply_run_updates.launches`
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from goctr_tpu_torch.ops.kernels import _build
from goctr_tpu_torch.ops.kernels.row_optimizer import (
    apply_run_sums, check_sorted_stream,
)
from goctr_tpu_torch.ops.segsum import sorted_run_sums

# the JAX kernel's (id | start << 29 | end << 30) stream: ids below
# 2^29 − 1, skip_ge at most 2^29 − 2
_ID_BITS = 29
ID_MASK = (1 << _ID_BITS) - 1
TILE_ROWS = 128       # csrc/run_rmw.cu kTileRows
GROUP_TILES = 128     # csrc/run_rmw.cu kGroupTiles
_NAME = "run_rmw"
# (table, ids, g, n, d, skip_ge, adagrad, lr, eps, ints, floats, stream)
_ARGTYPES = {"run_rmw": [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
             + [ctypes.c_int] + [ctypes.c_longlong] + [ctypes.c_int]
             + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3}
_count_lock = threading.Lock()


def pack_meta(s_ids: torch.Tensor) -> torch.Tensor:
    """SORTED ids [n] int32 → (id | start << 29 | end << 30) int32, bit
    for bit the stream the JAX kernel reads. The CUDA kernel reads run
    starts and ends from the neighbouring ids instead; this is kept as
    the JAX layout's record."""
    differs = s_ids[1:] != s_ids[:-1]
    start = torch.ones_like(s_ids, dtype=torch.bool)
    start[1:] = differs
    end = torch.ones_like(s_ids, dtype=torch.bool)
    end[:-1] = differs
    return (s_ids | (start.to(torch.int32) << _ID_BITS)
            | (end.to(torch.int32) << (_ID_BITS + 1)))


def apply_run_updates_plain(table: torch.Tensor, s_ids: torch.Tensor,
                            s_rows: torch.Tensor, lr: float, d: int,
                            kind: str = "adagrad", eps: float = 1e-8,
                            skip_ge: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K8 (run_optimizer.py:272-301): rows of ids
    outside [0, skip_ge) zeroed, run sums by `sorted_run_sums`, then
    `apply_run_sums` on the real runs' lines. Negative ids are never real
    (the JAX kernel's id mask skips them too). n % 1024 == 0."""
    if skip_ge is None:
        skip_ge = table.shape[0]
    in_range = (s_ids >= 0) & (s_ids < skip_ge)
    tgt, rows = sorted_run_sums(s_ids, s_rows * in_range[:, None],
                                junk_base=skip_ge + 1)
    sel = torch.nonzero((tgt >= 0) & (tgt < skip_ge)).flatten()
    return apply_run_sums(table, tgt[sel].long(), rows[sel], lr, d, kind,
                          eps)


def apply_run_updates(table: torch.Tensor, s_ids: torch.Tensor,
                      s_rows: torch.Tensor, lr: float, d: int,
                      kind: str = "adagrad", eps: float = 1e-8,
                      skip_ge: int | None = None) -> torch.Tensor:
    """Sorted-run row update (kernel K8) of the packed [V, 128] table, in
    place. s_ids [n] int32 sorted ascending with duplicates; s_rows [n, d]
    f32, each duplicate's gradient row; rows of ids >= skip_ge (pads,
    sorted last; they may point past the table) are skipped; n a multiple
    of 1024; skip_ge (default V) at most 2^29 − 2. Returns the table."""
    if skip_ge is None:
        skip_ge = table.shape[0]
    check_sorted_stream(table, s_ids, s_rows, d, kind, skip_ge, ID_MASK - 1)
    if table.device.type == "cpu":
        return apply_run_updates_plain(table, s_ids, s_rows, lr, d, kind,
                                       eps, skip_ge)
    if table.device.type != "cuda":
        raise ValueError(f"no {_NAME} kernel for {table.device}")
    n = s_ids.shape[0]
    if n == 0:
        return table
    dev = table.device
    n_tiles = -(-n // TILE_ROWS)
    n_groups = -(-n_tiles // GROUP_TILES)
    ints = torch.empty(2 * n_tiles + n_groups, dtype=torch.int32, device=dev)
    floats = torch.empty((2 * n_tiles + 2 * n_groups) * d,
                         dtype=torch.float32, device=dev)
    lib = _build.load(_NAME, _ARGTYPES)
    code = lib.run_rmw(table.data_ptr(), s_ids.data_ptr(), s_rows.data_ptr(),
                       n, d, skip_ge, int(kind == "adagrad"), lr, eps,
                       ints.data_ptr(), floats.data_ptr(),
                       torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, _NAME, code)
    with _count_lock:
        apply_run_updates.launches += 1
    return table


apply_run_updates.launches = 0
