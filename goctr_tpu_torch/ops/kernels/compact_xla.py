"""The fused table update's "xla" compaction in one device pass.

The JAX trainer's compact_impl="xla" front end (goctr_tpu/parallel/
scanned.py:296-311) is XLA glue, and so was the port's: the pads' rows
masked, every row permuted into id order, a two-level blocked cumsum
(ops/segsum.py `_cumsum_rows`), a second stable sort that moves the real
run ends to the front, their cumsum rows' differences (`compact_rank_sort`)
and the packing of each run's Σg into a [capr, 128] row (`pack_grads`).
`compact_xla_rows` does that work from the ids' stable sort (`sort_ids`)
and the rows as autograd gives them (bf16 or f32), bit for bit with the
glue on the card:

    tgt       [capr] int32   the real runs' ids (id < vocab) in id order,
                             then junk targets vocab + 1 + k;
    rows      [capr, 128] f32 (packed: Σg | ‖Σg‖² | 0 ..., the row
                             update's input at G = 1) or [capr, D] f32
                             (Σg: `line_stream`'s input on grouped lines,
                             and at D = 128, where weights and
                             accumulator are kept apart, the split row
                             update's, which sums ‖Σg‖² itself);
    overflow  [] int32       max(#real runs − capr, 0).

Every Σg lane equals the glue's; the packed ‖Σg‖² lane is summed in f64
and rounded once, so it lies within f32 rounding of the glue's
(rows · rows).sum(1), whose order of adds is PyTorch's own (relative
1e-6). At D = 1 PyTorch scans the block totals with a parallel scan (cub)
rather than a sequential one, so there the kernel is not bit for bit.

The CUDA kernel is csrc/compact_xla.cu; `compact_xla_rows_plain` is its
plain version, the glue itself. `compact_xla_rows` launches the kernel
for CUDA tensors and calls the plain version for CPU tensors; on any other
device, or when the kernel cannot be built or launched, it raises.
`compact_xla_rows.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from goctr_tpu_torch.ops.kernels import _build
from goctr_tpu_torch.ops.kernels.row_optimizer import (
    LANES, ROWS_PER_STEP, pack_grads,
)
from goctr_tpu_torch.ops.segsum import _cumsum_rows

_NAME = "compact_xla"
# (ids, s_ids, order, g, n0, n, dim, bf16, vocab, capr, packed, tgt, rows,
#  overflow, scratch, stream)
_ARGTYPES = {"compact_xla": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
             + [ctypes.c_int] * 3 + [ctypes.c_longlong] + [ctypes.c_int]
             + [ctypes.c_void_p] * 5}
DTYPES = (torch.bfloat16, torch.float32)
_count_lock = threading.Lock()


def sort_ids(ids_flat: torch.Tensor, vocab: int):
    """The compaction's id sort: pads (-1) become id `vocab`, the stream
    is padded to a multiple of ROWS_PER_STEP with the same, and a stable
    sort orders it. Returns (s_ids [n] int32, order [n] int64), s_ids =
    the padded ids taken in `order`."""
    n0 = ids_flat.shape[0]
    n = -(-n0 // ROWS_PER_STEP) * ROWS_PER_STEP
    ids = torch.where(ids_flat >= 0, ids_flat, vocab)
    if n > n0:
        ids = torch.cat([ids, torch.full((n - n0,), vocab, dtype=ids.dtype,
                                         device=ids.device)])
    s_ids, order = torch.sort(ids, stable=True)
    return s_ids, order


def compact_rank_sort(s_ids: torch.Tensor, g_s: torch.Tensor, vocab: int,
                      capr: int):
    """The JAX trainer's rank-sort compaction (scanned.py:296-311) of the
    sorted stream (s_ids [n] int32, g_s [n, D] f32): run sums as
    differences of consecutive run-end cumsum rows, the first capr real
    run ends selected by one stable sort. Returns (tgt [capr] int32,
    rows [capr, D] f32, overflow [] int32)."""
    n, d = g_s.shape
    dev = g_s.device
    c = _cumsum_rows(g_s)
    is_end = torch.cat([s_ids[1:] != s_ids[:-1],
                        torch.ones(1, dtype=torch.bool, device=dev)])
    real_end = is_end & (s_ids < vocab)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    sel = torch.sort(torch.where(real_end, pos, n + pos),
                     stable=True).indices[:capr]
    sel_real = real_end[sel]
    c_sel = c[sel]
    prev = torch.cat([c_sel.new_zeros((1, d)), c_sel[:-1]])
    rows = torch.where(sel_real[:, None], c_sel - prev, 0.0)
    tgt = torch.where(sel_real, s_ids[sel], vocab + 1 + pos[:capr])
    overflow = torch.clamp(real_end.sum() - capr, min=0).to(torch.int32)
    return tgt.to(torch.int32), rows, overflow


def _check(ids_flat, s_ids, order, g_flat, vocab, capr, packed) -> None:
    if ids_flat.dim() != 1 or ids_flat.dtype != torch.int32:
        raise ValueError(f"ids_flat must be [n0] int32, got "
                         f"{tuple(ids_flat.shape)} {ids_flat.dtype}")
    n0 = ids_flat.shape[0]
    n = -(-n0 // ROWS_PER_STEP) * ROWS_PER_STEP
    if (s_ids.dtype != torch.int32 or order.dtype != torch.int64
            or tuple(s_ids.shape) != (n,) or tuple(order.shape) != (n,)):
        raise ValueError(f"s_ids and order must be [{n}] int32 and int64 "
                         f"(sort_ids), got {tuple(s_ids.shape)} "
                         f"{s_ids.dtype}, {tuple(order.shape)} {order.dtype}")
    if g_flat.dim() != 2 or g_flat.shape[0] != n0 \
            or g_flat.dtype not in DTYPES:
        raise ValueError(f"g_flat must be [{n0}, D] bfloat16 or float32, "
                         f"got {tuple(g_flat.shape)} {g_flat.dtype}")
    top = LANES - 1 if packed else LANES    # a packed row holds ‖Σg‖² too
    if not 1 <= g_flat.shape[1] <= top:
        raise ValueError(f"D = {g_flat.shape[1]} must be in [1, {top}]"
                         + (" packed" if packed else ""))
    if len({t.device for t in (ids_flat, s_ids, order, g_flat)}) != 1:
        raise ValueError("ids_flat, s_ids, order and g_flat must be on one "
                         "device")
    if not all(t.is_contiguous() for t in (ids_flat, s_ids, order, g_flat)):
        raise ValueError("ids_flat, s_ids, order and g_flat must be "
                         "contiguous")
    if not 1 <= capr <= n or not 0 <= vocab < 2 ** 31 - 1 - capr:
        raise ValueError(f"capr={capr} must be in [1, {n}] and vocab + 1 + "
                         "capr must fit int32")


def scratch_floats(n: int, d: int) -> int:
    """4-byte words of the kernel's scratch (the kernel sets them): three
    [n / 1024, D] f32 planes (block totals, cumsums at the last real run
    end, offsets), then a count and a first slot a block and the total,
    int32."""
    nb = n // ROWS_PER_STEP
    return 3 * nb * d + 2 * nb + 1


def compact_xla_rows_plain(ids_flat: torch.Tensor, s_ids: torch.Tensor,
                           order: torch.Tensor, g_flat: torch.Tensor,
                           vocab: int, capr: int, packed: bool):
    """Plain PyTorch version: the glue. The rows cast to f32 and the pads'
    rows times 0, padded with zero rows to the sorted stream's length and
    taken in `order`, then `compact_rank_sort`, then `pack_grads` when
    packed."""
    n0, d = g_flat.shape
    n = s_ids.shape[0]
    g = g_flat.float() * (ids_flat >= 0)[:, None].float()
    if n > n0:
        g = torch.cat([g, g.new_zeros((n - n0, d))])
    tgt, rows, overflow = compact_rank_sort(s_ids, g[order], vocab, capr)
    return tgt, pack_grads(rows) if packed else rows, overflow


def compact_xla_rows(ids_flat: torch.Tensor, s_ids: torch.Tensor,
                     order: torch.Tensor, g_flat: torch.Tensor, vocab: int,
                     capr: int, packed: bool):
    """Raw ids [n0] int32 (-1 = pad), their `sort_ids` (s_ids [n] int32,
    order [n] int64) and the row gradients [n0, D] bf16 or f32 in batch
    order → (tgt [capr] int32, rows [capr, 128 if packed else D] f32,
    overflow [] int32); see the module docstring."""
    _check(ids_flat, s_ids, order, g_flat, vocab, capr, packed)
    if g_flat.device.type == "cpu":
        return compact_xla_rows_plain(ids_flat, s_ids, order, g_flat, vocab,
                                      capr, packed)
    if g_flat.device.type != "cuda":
        raise ValueError(f"no compact_xla kernel for {g_flat.device}")
    n0, d = g_flat.shape
    n = s_ids.shape[0]
    dev = g_flat.device
    tgt = torch.empty(capr, dtype=torch.int32, device=dev)
    rows = torch.empty((capr, LANES if packed else d), dtype=torch.float32,
                       device=dev)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(scratch_floats(n, d), dtype=torch.float32,
                          device=dev)
    lib = _build.load(_NAME, _ARGTYPES)
    code = lib.compact_xla(
        ids_flat.data_ptr(), s_ids.data_ptr(), order.data_ptr(),
        g_flat.data_ptr(), n0, n, d, int(g_flat.dtype == torch.bfloat16),
        vocab, capr, int(packed), tgt.data_ptr(), rows.data_ptr(),
        overflow.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, _NAME, code)
    with _count_lock:
        compact_xla_rows.launches += 1
    return tgt, rows, overflow


compact_xla_rows.launches = 0
