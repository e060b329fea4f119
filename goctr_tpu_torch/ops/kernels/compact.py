"""K9 — run-sum compaction of the sorted update stream.

Port of goctr_tpu/ops/pallas/compact.py::compact_runsums_block (the
compact_impl="kernel" front end of the fused table update). Given ids
sorted ascending (pads carry id `vocab` and sort last) and their gradient
rows [n, D] float32, it returns

    tgt       [capr] int32      ids of the real runs (id < vocab) in id
                                order, then junk targets vocab + 1 + k;
    rows      [capr, 128] f32   Σg of each run | ‖Σg‖² | 0 ... (junk 0);
    overflow  [] int32          max(#real runs − capr, 0): those runs'
                                updates are dropped, as in the JAX kernel.

The CUDA kernel is csrc/compact_runsums.cu; `compact_runsums_plain` is
its plain PyTorch version (a segment sum by run index). The JAX kernel
needs vocab < 2^24 because ids ride an f32 matmul on the TPU; here ids
stay int32 throughout, so only D < 127 is required (lane D holds ‖Σg‖²).

`compact_runsums_block` launches the kernel for CUDA tensors and calls
the plain version for CPU tensors; on any other device, or when the
kernel cannot be built or launched, it raises.
`compact_runsums_block.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from goctr_tpu_torch.ops.kernels import _build

LANES = 128
TILE_ROWS = 128       # csrc/compact_runsums.cu kTileRows
_NAME = "compact_runsums"
# (ids, g, n, dim, vocab, capr, tgt, rows, overflow, scratch, stream)
_ARGTYPES = {"compact_runsums": [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
             + [ctypes.c_int] * 2 + [ctypes.c_longlong]
             + [ctypes.c_void_p] * 5}
_count_lock = threading.Lock()


def _check(s_ids: torch.Tensor, g: torch.Tensor, vocab: int,
           capr: int) -> None:
    if s_ids.dim() != 1 or s_ids.dtype != torch.int32:
        raise ValueError(f"s_ids must be [n] int32, got "
                         f"{tuple(s_ids.shape)} {s_ids.dtype}")
    if g.dim() != 2 or g.shape[0] != s_ids.shape[0] \
            or g.dtype != torch.float32:
        raise ValueError(f"g_sorted must be [{s_ids.shape[0]}, D] float32, "
                         f"got {tuple(g.shape)} {g.dtype}")
    if g.shape[1] >= LANES - 1:
        raise ValueError(f"D = {g.shape[1]} must be < {LANES - 1}")
    if g.device != s_ids.device:
        raise ValueError("s_ids and g_sorted must be on one device")
    if not (s_ids.is_contiguous() and g.is_contiguous()):
        raise ValueError("s_ids and g_sorted must be contiguous")
    if capr < 1 or not 0 <= vocab < 2 ** 31 - 1 - capr:
        raise ValueError(f"capr={capr} must be >= 1 and vocab + 1 + capr "
                         "must fit int32")


def scratch_words(n: int, d: int) -> int:
    """8-byte words of the kernel's scratch (the kernel sets them): a word
    a tile and the ticket, rounded up to an even count, then each tile's
    tail of 4·ceil(D / 4) floats."""
    n_tiles = -(-n // TILE_ROWS)
    return (n_tiles + 2) // 2 * 2 + n_tiles * 2 * -(-d // 4)


def compact_runsums_plain(s_ids: torch.Tensor, g_sorted: torch.Tensor,
                          vocab: int, capr: int):
    """Plain PyTorch version of K9: run sums by `index_add_` over each
    row's run index, then the first capr real run ends."""
    n, d = g_sorted.shape
    dev = g_sorted.device
    ids = s_ids.long()
    is_end = torch.ones(n, dtype=torch.bool, device=dev)
    is_end[:-1] = ids[1:] != ids[:-1]
    run = torch.zeros(n, dtype=torch.long, device=dev)
    run[1:] = torch.cumsum(is_end[:-1].long(), 0)
    sums = torch.zeros((int(is_end.sum()), d), dtype=torch.float32,
                       device=dev).index_add_(0, run, g_sorted)
    ends = torch.nonzero(is_end & (ids < vocab)).flatten()
    total = ends.numel()
    live = ends[:capr]
    k = live.numel()
    rows = torch.zeros((capr, LANES), dtype=torch.float32, device=dev)
    rows[:k, :d] = sums[run[live]]
    rows[:k, d] = (rows[:k, :d] * rows[:k, :d]).sum(1)
    tgt = vocab + 1 + torch.arange(capr, dtype=torch.long, device=dev)
    tgt[:k] = ids[live]
    overflow = torch.tensor(max(total - capr, 0), dtype=torch.int32,
                            device=dev)
    return tgt.int(), rows, overflow


def compact_runsums_block(s_ids: torch.Tensor, g_sorted: torch.Tensor,
                          vocab: int, capr: int):
    """SORTED ids [n] int32 (pads = vocab, sorted last) + gradient rows
    [n, D] f32 → (tgt [capr] int32, rows [capr, 128] f32, overflow []
    int32); see the module docstring."""
    _check(s_ids, g_sorted, vocab, capr)
    if s_ids.device.type == "cpu":
        return compact_runsums_plain(s_ids, g_sorted, vocab, capr)
    if s_ids.device.type != "cuda":
        raise ValueError(f"no compact_runsums kernel for {s_ids.device}")
    n, d = g_sorted.shape
    dev = s_ids.device
    tgt = torch.empty(capr, dtype=torch.int32, device=dev)
    rows = torch.empty((capr, LANES), dtype=torch.float32, device=dev)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(scratch_words(n, d), dtype=torch.int64,
                          device=dev)
    lib = _build.load(_NAME, _ARGTYPES)
    code = lib.compact_runsums(
        s_ids.data_ptr(), g_sorted.data_ptr(), n, d, vocab, capr,
        tgt.data_ptr(), rows.data_ptr(), overflow.data_ptr(),
        scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, _NAME, code)
    with _count_lock:
        compact_runsums_block.launches += 1
    return tgt, rows, overflow


compact_runsums_block.launches = 0
