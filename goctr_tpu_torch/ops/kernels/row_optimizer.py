"""Packed embedding-table layouts and the row updates of the packed
update modes (port of goctr_tpu/ops/pallas/row_optimizer.py: LANES and
ROWS_PER_STEP :47-48, the one-pass row update apply_row_updates :146-229,
pack/unpack :238-262, the cumsum-difference update apply_csum_updates
:260-456, grouped lines and their one-pass update apply_line_updates
:470-751, the split updates and their write-only scatter :768-901,
pack_grads :904-911).

Two layouts, bit for bit the JAX package's, so a table packed by one
package unpacks in the other:

  * packed   [V, 128] f32 — one row per line: `w (D lanes) | acc | 0-pad`;
  * grouped  [ceil(V/G), 128] f32 — G = 128 // (D+1) rows per line, row r
    in line r // G at lanes (r % G)·(D+1) … +D (weights) and +D (acc);
    lanes past G·(D+1), and rows past the vocab in the last line, are 0.

The JAX package places lanes with 0/1 matmuls (a TPU tiling workaround);
here the lanes are written directly, which gives the same bits. Its
per-group adagrad spreads each group's accumulator over the group's
weight lanes with a 0/1 matmul (`make_spread`); each output lane of that
product has exactly one nonzero term, so reading the accumulator lane
directly (`acc_lanes`) gives the same f32 value.

Two ways to apply one batch's update rows, the same arithmetic in f32
(DLRM row-wise adagrad, per group on grouped lines, or sgd):

  * split (rmw_impl="split"): read the targeted lines with kernel K1,
    compute in torch, write them back with kernel K4
    (`scatter_rows_packed`, csrc/row_scatter.cu) —
    `apply_row_updates_split`, `apply_line_updates_split`, and at D = 128
    (a [V, 128] weight table, its accumulator a [V + 1] vector apart)
    `apply_wide_row_updates_split`;
  * one pass (rmw_impl="kernel"): kernel K5 (`apply_row_updates`) on
    packed rows, kernel K6 (`apply_line_updates`) on grouped lines, both
    in csrc/row_rmw.cu: each line is read, updated and written back by
    one warp, and only the real slots' lines are loaded (a persistent
    grid that lists each tile's real slots first).

update_mode="fused2" takes the sorted stream with its duplicates and
one cumsum of its rows instead: kernel K7 (`apply_csum_updates`,
csrc/csum_rmw.cu) recovers each run's Σg as the difference of two cumsum
rows and updates the run's line (runfused's K8 is
ops/kernels/run_optimizer.py).

Unlike the JAX functions, which return a new array, all of them update
the table IN PLACE and return it: a [10M, 128] table is 5.1 GB, the
100M × 16 lines 7.3 GB. Every target below skip_ge of K4, K5 and K6 must
be distinct (the trainer's front ends sum duplicates first): they would
race on a repeated line. The update rows are a tensor of their own, never a view
of the table (the wrappers refuse one that aliases it). Each wrapper
launches its kernel for CUDA tensors and calls its plain version for CPU
tensors; on any other device, or when the kernel cannot be built or
launched, it raises. `<wrapper>.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from goctr_tpu_torch.core.prng import randn_rows
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
_RMW = "row_rmw"
# (table, ids, updates, n, skip_ge, d, adagrad, lr, eps, stream)
_RMW_SIGNATURE = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 \
    + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
_RMW_ARGTYPES = {"row_rmw": _RMW_SIGNATURE, "line_rmw": _RMW_SIGNATURE}
KINDS = ("adagrad", "sgd")
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
                              d: int, scale: float = 0.01,
                              lines: tuple[int, int] | None = None
                              ) -> torch.Tensor:
    """Fresh grouped table N(0, scale²) on the weight lanes, zeros
    elsewhere, drawn straight into line layout on the generator's device
    (no [V, D] intermediate: 100M × 16 is 7.3 GB of lines). `lines`
    (l0, l1): only lines [l0, l1) of that table, lines past its end
    zeros (a model shard's lines, drawn without the others)."""
    g = group_size(d)
    n_lines = packed_lines(vocab, d)
    stride = d + 1
    if lines is None:
        l0, l1 = 0, n_lines
        table = torch.randn((n_lines, LANES), generator=generator,
                            dtype=torch.float32, device=generator.device)
    else:
        l0, l1 = lines
        table = torch.zeros((l1 - l0, LANES), dtype=torch.float32,
                            device=generator.device)
        hi = min(l1, n_lines)
        if hi > l0:
            table[:hi - l0] = randn_rows(generator, (n_lines, LANES), l0, hi)
    lane = torch.arange(LANES, device=table.device)
    live = (lane < g * stride) & ((lane % stride) < d)
    table.mul_(scale).masked_fill_(~live, 0.0)
    tail = n_lines * g - vocab             # pad rows in the last line
    if tail and l0 <= n_lines - 1 < l1:
        table[n_lines - 1 - l0, (g - tail) * stride:] = 0.0
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
    _refuse_alias(table, rows)


def _refuse_alias(table: torch.Tensor, rows: torch.Tensor) -> None:
    """The update rows are read while the table is written in place."""
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


def lane_masks(d: int, group: int = 1,
               device: torch.device | str = "cpu"):
    """(m_w, m_acc): [128] f32 0/1 masks of the weight lanes and of the
    accumulator lanes of a line that holds `group` (w | acc) groups of
    width d. group 1 is the packed row (w lanes < d, acc lane d)."""
    stride = d + 1
    lane = torch.arange(LANES, device=device)
    within = lane < group * stride
    m_w = (within & (lane % stride < d)).float()
    m_acc = (within & (lane % stride == d)).float()
    return m_w, m_acc


def acc_lanes(d: int, group: int,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """[128] int64 lane map: each weight lane → the accumulator lane of
    its group; every other lane → itself (its weight mask is 0). The
    JAX package's `make_spread` 0/1 matrix (:475-484) as an index."""
    stride = d + 1
    lane = torch.arange(LANES, device=device)
    m_w, _ = lane_masks(d, group, device)
    return torch.where(m_w > 0, lane // stride * stride + d, lane)


def rmw_lines(cur: torch.Tensor, upd: torch.Tensor, lr: float, d: int,
              kind: str = "adagrad", eps: float = 1e-8,
              group: int = 1) -> torch.Tensor:
    """New lines from the current lines `cur` and the update rows `upd`
    ([n, 128] f32 each; upd's weight lanes carry Σg, its accumulator
    lanes ‖Σg‖²), per group of the line:

        acc' = acc + ‖Σg‖²,   w' = w − lr · Σg · rsqrt(acc' + eps)

    (DLRM row-wise adagrad) or sgd (w' = w − lr · Σg), in f32 and term by
    term as the JAX kernels compute them (row_optimizer.py:110-116,
    :642-650). Every lane but the weight lanes keeps `cur + upd·m_acc`:
    the JAX kernels subtract `scale · (upd·m_w)` = 0 there, the same value
    while scale is finite, but NaN on grouped lines at eps = 0
    (rsqrt(0) · 0); here those lanes stay finite."""
    if kind not in KINDS:
        raise ValueError(f"unknown row optimizer {kind!r}")
    m_w, m_acc = lane_masks(d, group, cur.device)
    weight = m_w > 0
    if kind == "sgd":
        return torch.where(weight, cur - lr * upd, cur)
    r_acc = cur + upd * m_acc
    if group == 1:
        acc = r_acc[:, d:d + 1]
    else:
        acc = r_acc.index_select(1, acc_lanes(d, group, cur.device))
    scale = lr * torch.rsqrt(acc + eps)
    return torch.where(weight, r_acc - scale * upd, r_acc)


def updated_lines(table: torch.Tensor, ids: torch.Tensor,
                  upd: torch.Tensor, lr: float, d: int,
                  kind: str = "adagrad", eps: float = 1e-8,
                  group: int = 1) -> torch.Tensor:
    """The new lines of `ids` ([n, 128] f32, a fresh tensor): the current
    lines read with kernel K1 (junk ids past the table read the last
    line), then `rmw_lines`."""
    cur = gather_rows(table, ids.clamp(max=table.shape[0] - 1), dim=LANES)
    return rmw_lines(cur, upd, lr, d, kind, eps, group)


def apply_row_updates_split(table: torch.Tensor, ids: torch.Tensor,
                            g_packed: torch.Tensor, lr: float, d: int,
                            kind: str = "adagrad", eps: float = 1e-8,
                            skip_ge: int | None = None) -> torch.Tensor:
    """Split row update on the packed [V, 128] table, in place: the rows
    of `updated_lines`, written back with K4. ids [n] int32 pairwise
    distinct below skip_ge (junk targets past it are skipped); g_packed
    [n, 128] is (g | ‖g‖² | 0)."""
    new = updated_lines(table, ids, g_packed, lr, d, kind, eps)
    return scatter_rows_packed(table, ids, new, skip_ge=skip_ge)


def apply_line_updates_split(table: torch.Tensor, line_ids: torch.Tensor,
                             line_updates: torch.Tensor, lr: float, d: int,
                             kind: str = "adagrad", eps: float = 1e-8,
                             skip_ge: int | None = None) -> torch.Tensor:
    """Split update of the grouped [L, 128] lines, in place: per-group
    adagrad or sgd on the lines of `updated_lines`, written back with K4.
    line_ids [n] int32 pairwise distinct below skip_ge; line_updates
    [n, 128] lane-placed (each touched group's Σg on its weight lanes,
    ‖Σg‖² on its accumulator lane)."""
    new = updated_lines(table, line_ids, line_updates, lr, d, kind, eps,
                        group_size(d))
    return scatter_rows_packed(table, line_ids, new, skip_ge=skip_ge)


def apply_wide_row_updates_split(table: torch.Tensor, acc: torch.Tensor,
                                 ids: torch.Tensor, g: torch.Tensor,
                                 lr: float, kind: str = "adagrad",
                                 eps: float = 1e-8,
                                 skip_ge: int | None = None) -> torch.Tensor:
    """Split row update of a [V, 128] weight table whose accumulator is
    kept apart (D = 128 leaves no lane for it), in place: each target's
    row read with K1, DLRM row-wise adagrad

        acc' = acc + ‖Σg‖²,   w' = w − lr · Σg · rsqrt(acc' + eps)

    (‖Σg‖² summed over the 128 lanes from the f32 rows, as in every row
    update here; FBGEMM's EXACT_ROWWISE_ADAGRAD adds its mean over them)
    or sgd in torch, the whole rows
    written back with K4, and the accumulator read and written by index.
    ids [n] int32 pairwise distinct below skip_ge (junk targets past it
    are skipped); g [n, 128] f32 Σg rows; acc [skip_ge + 1] f32, its last
    entry a spare that the junk targets' accumulator writes land on (a
    write by index cannot skip them without waiting on the card)."""
    if kind not in KINDS:
        raise ValueError(f"unknown row optimizer {kind!r}")
    if skip_ge is None:
        skip_ge = table.shape[0]
    if acc.shape != (skip_ge + 1,) or g.shape != (ids.shape[0], LANES):
        raise ValueError(f"acc must be [{skip_ge + 1}] and g "
                         f"[{ids.shape[0]}, {LANES}], got "
                         f"{tuple(acc.shape)}, {tuple(g.shape)}")
    cur = gather_rows(table, ids.clamp(max=table.shape[0] - 1), dim=LANES)
    if kind == "sgd":
        new = cur - lr * g
    else:
        slot = torch.where(ids < skip_ge, ids, skip_ge).long()
        a = acc.index_select(0, slot) + (g * g).sum(1)
        acc.index_copy_(0, slot, a)
        new = cur - lr * g * torch.rsqrt(a + eps)[:, None]
    return scatter_rows_packed(table, ids, new, skip_ge=skip_ge)


def _rmw_plain(table, ids, upd, lr, d, kind, eps, skip_ge, group):
    """Plain PyTorch version of K5 (group 1) and K6: `index_select` of
    the clamped ids, `rmw_lines`, `index_put_` of the real rows, as the
    JAX fallbacks (:204-229, :729-751)."""
    if skip_ge is None:
        skip_ge = table.shape[0]
    cur = table.index_select(0, ids.clamp(0, table.shape[0] - 1).long())
    new = rmw_lines(cur, upd, lr, d, kind, eps, group)
    real = (ids >= 0) & (ids < skip_ge)
    table.index_put_((ids[real].long(),), new[real])
    return table


def apply_row_updates_plain(table: torch.Tensor, ids: torch.Tensor,
                            g_packed: torch.Tensor, lr: float, d: int,
                            kind: str = "adagrad", eps: float = 1e-8,
                            skip_ge: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K5 (`apply_row_updates`)."""
    return _rmw_plain(table, ids, g_packed, lr, d, kind, eps, skip_ge, 1)


def apply_line_updates_plain(table: torch.Tensor, line_ids: torch.Tensor,
                             line_updates: torch.Tensor, lr: float, d: int,
                             kind: str = "adagrad", eps: float = 1e-8,
                             skip_ge: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K6 (`apply_line_updates`)."""
    return _rmw_plain(table, line_ids, line_updates, lr, d, kind, eps,
                      skip_ge, group_size(d))


def _rmw(entry: str, plain, table, ids, upd, lr, d, kind, eps, skip_ge):
    """Check, then launch kernel `entry` of csrc/row_rmw.cu on a CUDA
    table or call `plain` on a CPU one. Returns True on a launch."""
    if skip_ge is None:
        skip_ge = table.shape[0]
    if not 0 < d < LANES:
        raise ValueError(f"the fused row update requires 0 < d < {LANES}, "
                         f"got {d}")
    if kind not in KINDS:
        raise ValueError(f"unknown row optimizer {kind!r}")
    _check_scatter(table, ids, upd, skip_ge)
    if table.device.type == "cpu":
        plain(table, ids, upd, lr, d, kind, eps, skip_ge)
        return False
    if table.device.type != "cuda":
        raise ValueError(f"no {entry} kernel for {table.device}")
    n = ids.shape[0]
    if n == 0:
        return False
    lib = _build.load(_RMW, _RMW_ARGTYPES)
    code = getattr(lib, entry)(
        table.data_ptr(), ids.data_ptr(), upd.data_ptr(), n, skip_ge, d,
        int(kind == "adagrad"), lr, eps,
        torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(lib, _RMW, code)
    return True


def apply_row_updates(table: torch.Tensor, ids: torch.Tensor,
                      g_packed: torch.Tensor, lr: float, d: int,
                      kind: str = "adagrad", eps: float = 1e-8,
                      skip_ge: int | None = None) -> torch.Tensor:
    """One-pass row update (kernel K5) of the packed [V, 128] table, in
    place: each real row is read, updated (`rmw_lines`, group 1) and
    written back. ids [n] int32 pairwise distinct below skip_ge (ids >=
    skip_ge, which may point past the table, are skipped); g_packed
    [n, 128] f32 (g | ‖g‖² | 0). Returns the table."""
    if _rmw("row_rmw", apply_row_updates_plain, table, ids, g_packed, lr,
            d, kind, eps, skip_ge):
        with _count_lock:
            apply_row_updates.launches += 1
    return table


apply_row_updates.launches = 0


def apply_line_updates(table: torch.Tensor, line_ids: torch.Tensor,
                       line_updates: torch.Tensor, lr: float, d: int,
                       kind: str = "adagrad", eps: float = 1e-8,
                       skip_ge: int | None = None) -> torch.Tensor:
    """One-pass update (kernel K6) of the grouped [L, 128] lines, in
    place: per-group adagrad or sgd (`rmw_lines`, G = 128 // (d+1)) on
    each real line. line_ids [n] int32 pairwise distinct below skip_ge
    (ids >= skip_ge are skipped); line_updates [n, 128] lane-placed.
    Returns the table."""
    if _rmw("line_rmw", apply_line_updates_plain, table, line_ids,
            line_updates, lr, d, kind, eps, skip_ge):
        with _count_lock:
            apply_line_updates.launches += 1
    return table


apply_line_updates.launches = 0


# ----------------------------------------------- K7: cumsum differences --
# the JAX kernel's id | run_end << 30 stream (row_optimizer.py:260-268):
# ids below 2^30 − 1, skip_ge at most 2^30 − 2
_END = 1 << 30
_CSUM_ID_MASK = _END - 1
_CSUM = "csum_rmw"
# (table, ids, c, n, d, skip_ge, adagrad, lr, eps, stream)
_CSUM_ARGTYPES = {"csum_rmw": [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                  + [ctypes.c_int] + [ctypes.c_longlong] + [ctypes.c_int]
                  + [ctypes.c_float] * 2 + [ctypes.c_void_p]}


def pack_end_meta(s_ids: torch.Tensor) -> torch.Tensor:
    """SORTED ids [n] int32 → (id | run_end << 30) int32, bit for bit the
    stream the JAX kernel reads. The CUDA kernel reads the run ends from
    the neighbouring ids instead; this is kept as the JAX layout's
    record."""
    end = torch.ones_like(s_ids, dtype=torch.bool)
    end[:-1] = s_ids[1:] != s_ids[:-1]
    return s_ids | (end.to(torch.int32) << 30)


def check_sorted_stream(table: torch.Tensor, s_ids: torch.Tensor,
                        rows: torch.Tensor, d: int, kind: str,
                        skip_ge: int, id_cap: int) -> None:
    """The argument checks of K7 and K8, in the JAX package's order (d,
    then the id cap), then the shapes the kernels take: table [V, 128]
    f32, s_ids [n] int32, rows [n, d] f32 with n a multiple of
    ROWS_PER_STEP, skip_ge <= V, rows not aliasing the table."""
    if not 0 < d < LANES:
        raise ValueError(f"the sorted-stream row update requires 0 < d < "
                         f"{LANES}, got {d}")
    if skip_ge > id_cap:
        raise ValueError(f"vocab {skip_ge} exceeds the id cap {id_cap}")
    if kind not in KINDS:
        raise ValueError(f"unknown row optimizer {kind!r}")
    if table.dim() != 2 or table.shape[1] != LANES \
            or table.dtype != torch.float32:
        raise ValueError(f"table must be [V, {LANES}] float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if s_ids.dim() != 1 or s_ids.dtype != torch.int32:
        raise ValueError(f"s_ids must be [n] int32, got "
                         f"{tuple(s_ids.shape)} {s_ids.dtype}")
    n = s_ids.shape[0]
    if tuple(rows.shape) != (n, d) or rows.dtype != torch.float32:
        raise ValueError(f"rows must be [{n}, {d}] float32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if n % ROWS_PER_STEP:
        raise ValueError(f"n={n} must be a multiple of {ROWS_PER_STEP}")
    if s_ids.device != table.device or rows.device != table.device:
        raise ValueError("table, s_ids and rows must be on one device")
    if not (table.is_contiguous() and s_ids.is_contiguous()
            and rows.is_contiguous()):
        raise ValueError("table, s_ids and rows must be contiguous")
    if not 0 <= skip_ge <= table.shape[0]:
        raise ValueError(f"skip_ge={skip_ge} must lie in [0, "
                         f"{table.shape[0]}]")
    _refuse_alias(table, rows)


def apply_run_sums(table: torch.Tensor, ids: torch.Tensor,
                   sums: torch.Tensor, lr: float, d: int, kind: str,
                   eps: float) -> torch.Tensor:
    """The plain versions' row update of distinct lines `ids` ([m] int64)
    from their run sums [m, d]: `pack_grads` (‖Σg‖² at lane d), the
    current lines read with `index_select`, `rmw_lines`, `index_put_`."""
    new = rmw_lines(table.index_select(0, ids), pack_grads(sums), lr, d,
                    kind, eps)
    return table.index_put_((ids,), new)


def apply_csum_updates_plain(table: torch.Tensor, s_ids: torch.Tensor,
                             c_rows: torch.Tensor, lr: float, d: int,
                             kind: str = "adagrad", eps: float = 1e-8,
                             skip_ge: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K7, the JAX fallback's arithmetic
    (row_optimizer.py:422-456): each real run end's Σg = its cumsum row
    minus that of the previous real run end (a cummax over the real ends'
    positions; none: minus 0), then `apply_run_sums`. A real run end is
    the last position of a run of an id in [0, skip_ge): negative ids are
    never real (the JAX kernel's id mask skips them too)."""
    if skip_ge is None:
        skip_ge = table.shape[0]
    n = s_ids.shape[0]
    if n == 0:
        return table
    end = torch.ones_like(s_ids, dtype=torch.bool)
    end[:-1] = s_ids[1:] != s_ids[:-1]
    real = end & (s_ids >= 0) & (s_ids < skip_ge)
    pos = torch.arange(n, device=s_ids.device)
    last = torch.cummax(torch.where(real, pos, -1), 0).values
    prev_end = torch.cat([last.new_full((1,), -1), last[:-1]])
    sel = torch.nonzero(real).flatten()
    p = prev_end[sel]
    prev_c = torch.where((p >= 0)[:, None], c_rows[p.clamp_min(0)], 0.0)
    return apply_run_sums(table, s_ids[sel].long(), c_rows[sel] - prev_c,
                          lr, d, kind, eps)


def apply_csum_updates(table: torch.Tensor, s_ids: torch.Tensor,
                       c_rows: torch.Tensor, lr: float, d: int,
                       kind: str = "adagrad", eps: float = 1e-8,
                       skip_ge: int | None = None) -> torch.Tensor:
    """Cumsum-difference row update (kernel K7, csrc/csum_rmw.cu) of the
    packed [V, 128] table, in place: at each position that ends a run of
    an id in [0, skip_ge), Σg = c_rows there minus c_rows at the previous
    such run end, then row-wise adagrad or sgd on the id's line
    (`rmw_lines`). s_ids [n] int32 sorted ascending (duplicates adjacent;
    pads >= skip_ge sort last, skipped, and may point past the table);
    c_rows [n, d] f32, the inclusive cumsum of the sorted gradient rows
    (zero rows for pads); n a multiple of 1024; skip_ge (default V) at
    most 2^30 − 2. Returns the table."""
    if skip_ge is None:
        skip_ge = table.shape[0]
    check_sorted_stream(table, s_ids, c_rows, d, kind, skip_ge,
                        _CSUM_ID_MASK - 1)
    if table.device.type == "cpu":
        return apply_csum_updates_plain(table, s_ids, c_rows, lr, d, kind,
                                        eps, skip_ge)
    if table.device.type != "cuda":
        raise ValueError(f"no {_CSUM} kernel for {table.device}")
    n = s_ids.shape[0]
    if n == 0:
        return table
    lib = _build.load(_CSUM, _CSUM_ARGTYPES)
    code = lib.csum_rmw(table.data_ptr(), s_ids.data_ptr(), c_rows.data_ptr(),
                        n, d, skip_ge, int(kind == "adagrad"), lr, eps,
                        torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(lib, _CSUM, code)
    with _count_lock:
        apply_csum_updates.launches += 1
    return table


apply_csum_updates.launches = 0
