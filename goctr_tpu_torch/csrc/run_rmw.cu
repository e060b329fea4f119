// Sorted-run row update of the packed [V, 128] table (K8).
//
// Replaces: goctr_tpu/ops/pallas/run_optimizer.py::_kernel /
// apply_run_updates (pallas_call at :242), the table update of
// update_mode="runfused" (goctr_tpu/parallel/scanned.py:214-237).
//
// Input: ids [n] int32 sorted ascending with duplicates (pads carry id >=
// skip_ge and sort last), their gradient rows g [n, d] f32, and the table
// [V, 128] f32 (w | acc | 0), updated in place. For each run of a real id
// (0 <= id < skip_ge): Σg = the sum of the run's rows, then the row-wise
// adagrad or sgd update of its line (line_update.cuh). Rows of other ids
// are never read.
//
// What bounds it on the H100: bytes. It reads the ids and the rows of
// real ids once, and reads and writes the 32-byte sectors of each real
// line that hold its d+1 live lanes; its per-tile carries are a few MB.
// At the headline's first step (n = 2,162,688 rows, 519,364 real runs,
// d = 64: 256 B a row, 288 B of line a run) that is ~0.86 GB, ~0.26 ms at
// 3.35 TB/s. The adds (n·d) are far below the card's f32 rate.
// Design: the TPU kernel walks positions in grid order and keeps the open
// run's sum in VMEM across grid steps (:120-137). CUDA blocks run in no
// order, so, as K9 (compact_runsums.cu) does:
//   1. tiles:  one warp per 128-row tile walks its rows in order with the
//              open run's sum in registers (thread l holds dims 4l … 4l+3;
//              8 rows' loads in flight). A real run that starts and ends
//              in the tile is updated at once (kBatch lines at a time);
//              the tile leaves the sum of the run still open at its end
//              (its tail), whether a run starts in it (pass = no start),
//              and, when its first run began before it and ends in it, that
//              run's id and its part of the sum (the head);
//   2-4. carry: the sum each tile inherits from runs that began before it
//              is a segmented scan of the tails (a run start cuts it):
//              one block per group of 128 tiles folds the group, one
//              block scans the groups, and one block per group walks its
//              tiles again and adds the inherited sum to each head;
//   5. heads:  one warp per kBatch tiles updates their heads' lines.
// A hot zipf id whose run covers 10^5 rows is thus summed by ~800 warps in
// parallel plus two short scans, never by one warp walking the run, and no
// [n, 128] update stream is written (that would be K9 followed by K5).
// The TPU kernel sums a run in position order, this kernel in tile order
// (tile sums, then the carry, then the head), and the plain version, like
// JAX's jnp fallback, as a difference of two cumsum rows: the three agree
// to f32 rounding of the sums, not bit for bit. Sums run in a fixed
// order, so a run repeats bit for bit.
// Plain version: apply_run_updates_plain in
// goctr_tpu_torch/ops/kernels/run_optimizer.py.
#include <cuda_runtime.h>

#include "line_update.cuh"

namespace {

using line_update::Batch;
using line_update::kBatch;
using line_update::kFull;

constexpr int kTileRows = 128;     // rows per warp tile (run_optimizer.py: TILE_ROWS)
constexpr int kGroupTiles = 128;   // tiles per carry group (GROUP_TILES)
constexpr int kWarpsPerBlock = 8;
constexpr int kLanes = line_update::kLanes;

template <bool kAdagrad>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tile_kernel(float* __restrict__ table, const int* __restrict__ ids,
            const float* __restrict__ g, long long n, int d, long long skip_ge,
            float lr, float eps, long long n_tiles,
            float* __restrict__ tile_tail, int* __restrict__ tile_pass,
            float* __restrict__ head, int* __restrict__ head_id) {
  const long long tile =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (tile >= n_tiles) return;
  const int lane = threadIdx.x & 31;
  const long long s = tile * kTileRows;
  const long long e = s + kTileRows < n ? s + kTileRows : n;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float h[4] = {0.f, 0.f, 0.f, 0.f};
  int h_id = -1;
  bool open = true;  // the current run began before this tile
  unsigned any_start = 0;
  Batch b;
  b.count = 0;
  for (long long j0 = s; j0 < e; j0 += 32) {
    const long long j = j0 + lane;
    int id = -1;
    bool st = false, en = false;
    if (j < e) {
      id = __ldg(ids + j);
      st = j == 0 || __ldg(ids + j - 1) != id;
      en = j == n - 1 || __ldg(ids + j + 1) != id;
    }
    const bool in_range = j < e && id >= 0 && id < skip_ge;
    const unsigned starts = __ballot_sync(kFull, st);
    const unsigned ends = __ballot_sync(kFull, en);
    const unsigned reals = __ballot_sync(kFull, in_range && en);
    const unsigned rows_in = __ballot_sync(kFull, in_range);
    any_start |= starts;
    const int rows_here = static_cast<int>(e - j0 < 32 ? e - j0 : 32);
    for (int r0 = 0; r0 < rows_here; r0 += 8) {
      float v[8][4];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int dim = 4 * lane + k;
          v[q][k] = r0 + q < rows_here && ((rows_in >> (r0 + q)) & 1u) && dim < d
                        ? __ldg(g + (j0 + r0 + q) * d + dim) : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int r = r0 + q;
        if (r >= rows_here) break;
        if ((starts >> r) & 1u) {
          open = false;
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[k] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], v[q][k]);
        if ((ends >> r) & 1u) {
          if ((reals >> r) & 1u) {
            const int rid = __shfl_sync(kFull, id, r);
            if (open) {  // the run began before this tile: finish it later
              h_id = rid;
#pragma unroll
              for (int k = 0; k < 4; ++k) h[k] = acc[k];
            } else {
              line_update::push(b, rid, acc);
              if (b.count == kBatch)
                line_update::flush<kAdagrad>(table, b, d, lr, eps, lane);
            }
          }
          open = false;
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[k] = 0.f;
        }
      }
    }
  }
  line_update::flush<kAdagrad>(table, b, d, lr, eps, lane);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dim = 4 * lane + k;
    if (dim < d) {
      tile_tail[tile * d + dim] = acc[k];
      head[tile * d + dim] = h[k];
    }
  }
  if (lane == 0) {
    tile_pass[tile] = any_start == 0;  // the open run passes through the tile
    head_id[tile] = h_id;
  }
}

// One block (thread = dim) per group: fold the group's tiles into one
// (pass, tail) pair: carry_out = pass ? carry_in + tail : tail.
__global__ void __launch_bounds__(kLanes)
group_kernel(const float* __restrict__ tile_tail,
             const int* __restrict__ tile_pass, long long n_tiles, int d,
             float* __restrict__ group_tail, int* __restrict__ group_pass) {
  const int dim = threadIdx.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * kGroupTiles;
  const long long t1 = t0 + kGroupTiles < n_tiles ? t0 + kGroupTiles : n_tiles;
  float c = 0.f;
  bool all = true;
#pragma unroll 8
  for (long long t = t0; t < t1; ++t) {
    const bool p = tile_pass[t] != 0;
    const float tail = dim < d ? tile_tail[t * d + dim] : 0.f;
    c = p ? __fadd_rn(c, tail) : tail;
    all = all && p;
  }
  if (dim < d) group_tail[blockIdx.x * static_cast<long long>(d) + dim] = c;
  if (dim == 0) group_pass[blockIdx.x] = all;
}

// One block: the carry each group inherits from the groups before it.
__global__ void __launch_bounds__(kLanes)
group_scan_kernel(const float* __restrict__ group_tail,
                  const int* __restrict__ group_pass, long long n_groups, int d,
                  float* __restrict__ group_carry) {
  const int dim = threadIdx.x;
  if (dim >= d) return;
  float c = 0.f;
#pragma unroll 8
  for (long long gi = 0; gi < n_groups; ++gi) {
    group_carry[gi * d + dim] = c;
    const float tail = group_tail[gi * d + dim];
    c = group_pass[gi] ? __fadd_rn(c, tail) : tail;
  }
}

// One block per group: walk its tiles with the inherited carry and add it
// to the head of each tile that has one.
__global__ void __launch_bounds__(kLanes)
carry_kernel(const float* __restrict__ tile_tail,
             const int* __restrict__ tile_pass,
             const int* __restrict__ head_id,
             const float* __restrict__ group_carry, long long n_tiles, int d,
             float* __restrict__ head) {
  const int dim = threadIdx.x;
  if (dim >= d) return;
  const long long t0 = static_cast<long long>(blockIdx.x) * kGroupTiles;
  const long long t1 = t0 + kGroupTiles < n_tiles ? t0 + kGroupTiles : n_tiles;
  float c = group_carry[blockIdx.x * static_cast<long long>(d) + dim];
#pragma unroll 8
  for (long long t = t0; t < t1; ++t) {
    if (head_id[t] >= 0) head[t * d + dim] = __fadd_rn(c, head[t * d + dim]);
    const float tail = tile_tail[t * d + dim];
    c = tile_pass[t] ? __fadd_rn(c, tail) : tail;
  }
}

// One warp per kBatch tiles: the update of each tile's head run.
template <bool kAdagrad>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
heads_kernel(float* __restrict__ table, const float* __restrict__ head,
             const int* __restrict__ head_id, long long n_tiles, int d,
             float lr, float eps) {
  const int lane = threadIdx.x & 31;
  const long long t0 =
      (static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32) * kBatch;
  if (t0 >= n_tiles) return;
  Batch b;
  b.count = 0;
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const long long t = t0 + i;
    if (t >= n_tiles) break;
    const int id = head_id[t];
    if (id < 0) continue;
    float gv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int dim = 4 * lane + k;
      gv[k] = dim < d ? head[t * d + dim] : 0.f;
    }
    line_update::push(b, id, gv);
  }
  line_update::flush<kAdagrad>(table, b, d, lr, eps, lane);
}

unsigned blocks_for(long long items, long long per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

template <bool kAdagrad>
void launch_all(float* table, const int* ids, const float* g, long long n, int d,
                long long skip_ge, float lr, float eps, long long n_tiles,
                long long n_groups, int* tile_pass, int* group_pass,
                int* head_id, float* tile_tail, float* head,
                float* group_tail, float* group_carry, cudaStream_t s) {
  const dim3 warps(kWarpsPerBlock * 32);
  tile_kernel<kAdagrad><<<blocks_for(n_tiles, kWarpsPerBlock), warps, 0, s>>>(
      table, ids, g, n, d, skip_ge, lr, eps, n_tiles, tile_tail, tile_pass, head,
      head_id);
  group_kernel<<<static_cast<unsigned>(n_groups), kLanes, 0, s>>>(
      tile_tail, tile_pass, n_tiles, d, group_tail, group_pass);
  group_scan_kernel<<<1, kLanes, 0, s>>>(group_tail, group_pass, n_groups, d,
                                         group_carry);
  carry_kernel<<<static_cast<unsigned>(n_groups), kLanes, 0, s>>>(
      tile_tail, tile_pass, head_id, group_carry, n_tiles, d, head);
  heads_kernel<kAdagrad><<<blocks_for(n_tiles, kWarpsPerBlock * kBatch), warps, 0, s>>>(
      table, head, head_id, n_tiles, d, lr, eps);
}

}  // namespace

// table [V, 128] f32 (16-byte aligned), ids [n] int32 sorted, g [n, d]
// f32; 0 < d < 128, skip_ge <= V.
// ints:   int32 scratch of 2 * n_tiles + n_groups entries;
// floats: f32 scratch of (2 * n_tiles + 2 * n_groups) * d entries;
// n_tiles = ceil(n / 128), n_groups = ceil(n_tiles / 128).
extern "C" int run_rmw(void* table, const void* ids, const void* g, long long n,
                       int d, long long skip_ge, int adagrad, float lr,
                       float eps, void* ints, void* floats, void* stream) {
  if (d <= 0 || d >= kLanes) return cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  const long long n_groups = (n_tiles + kGroupTiles - 1) / kGroupTiles;
  int* tile_pass = static_cast<int*>(ints);
  int* head_id = tile_pass + n_tiles;
  int* group_pass = head_id + n_tiles;
  float* tile_tail = static_cast<float*>(floats);
  float* head = tile_tail + n_tiles * d;
  float* group_tail = head + n_tiles * d;
  float* group_carry = group_tail + n_groups * d;
  auto* t = static_cast<float*>(table);
  const auto* i = static_cast<const int*>(ids);
  const auto* gr = static_cast<const float*>(g);
  auto s = static_cast<cudaStream_t>(stream);
  if (adagrad) {
    launch_all<true>(t, i, gr, n, d, skip_ge, lr, eps, n_tiles, n_groups,
                     tile_pass, group_pass, head_id, tile_tail, head, group_tail,
                     group_carry, s);
  } else {
    launch_all<false>(t, i, gr, n, d, skip_ge, lr, eps, n_tiles, n_groups,
                      tile_pass, group_pass, head_id, tile_tail, head, group_tail,
                      group_carry, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* run_rmw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
