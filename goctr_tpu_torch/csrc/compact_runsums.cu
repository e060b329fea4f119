// Run-sum compaction of the sorted update stream (K9).
//
// Replaces: goctr_tpu/ops/pallas/compact.py::_kernel /
// compact_runsums_block (pallas_call at :129), the compact_impl="kernel"
// front end of the fused table update (goctr_tpu/parallel/scanned.py:
// 288-294).
//
// Input: ids [n] int32 sorted ascending (pads carry id `vocab` and sort
// last), their gradient rows g [n, D] f32 (D < 127), and capr. Output:
//   tgt  [capr] int32: the ids of the real runs (id < vocab), in id order,
//        then junk targets vocab + 1 + k for the slots k past them;
//   rows [capr, 128] f32: Σg of each run | ‖Σg‖² | 0 ... (junk slots 0);
//   overflow [1] int32: max(#real runs − capr, 0) — those runs' updates
//        are dropped, as in the JAX kernel.
//
// What bounds it on the H100: bytes. It reads the ids and the gradient
// rows once (8.7 MB + 553.6 MB at the headline step, n = 2,162,688,
// D = 64) and writes capr 512-byte rows: ~0.78 GB, ~0.23 ms at 3.35 TB/s.
// The adds (n·D) are far below the card's f32 rate.
// Design: the TPU kernel walks 512-row blocks in grid order, carries the
// open run's sum from block to block in VMEM scratch (:90-95) and picks
// run ends with exact 0/1 matmuls. CUDA blocks run in no order, so:
//   1. count:  one warp per 128-row tile counts the tile's real run ends
//              (ballot + popc on the ids alone) and notes whether a run
//              starts inside the tile;
//   2. scan:   one block scans the tile counts into each tile's first
//              output slot, the total and the overflow;
//   3. tiles:  one warp per tile walks its rows in order with the open
//              run's sum in registers (lane l holds dims l, l+32, ...),
//              and at each real run end writes the tile-local part of the
//              run's sum straight into its compacted slot; it leaves the
//              sum of the run still open at the tile's end (its tail) and
//              the slot of its first end if that run began before the tile;
//   4-6. carry: the sum each tile inherits from runs that began before it
//              is a segmented scan of the tails (a run start cuts it):
//              one block per group of 128 tiles folds the group, one
//              block scans the groups, and one block per group walks its
//              tiles again and adds the inherited sum to the one slot per
//              tile that needs it;
//   7. finish: one warp per slot writes ‖Σg‖² and zero lanes, and fills
//              the junk slots.
// A hot zipf id whose run covers 10^5 rows is thus summed by ~800 warps
// in parallel plus two short scans, never by one warp walking the run.
// Compaction writes the [capr, 128] output directly; the TPU kernel's
// position-aligned [n, 128] intermediate has no counterpart. Sums run in
// a fixed order, so a run repeats bit for bit.
// Plain version: compact_runsums_plain in
// goctr_tpu_torch/ops/kernels/compact.py.
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 128;     // rows per warp tile (compact.py: TILE_ROWS)
constexpr int kGroupTiles = 128;   // tiles per carry group (GROUP_TILES)
constexpr int kWarpsPerBlock = 8;
constexpr int kLanes = 128;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct RowFlags {
  unsigned start, end, real;  // bit r: row j0 + r starts / ends a run / ends a real run
  int id;                     // this lane's row id
};

// Flags of rows j0 + lane (lane < e - j0) of the sorted ids.
__device__ __forceinline__ RowFlags row_flags(const int* __restrict__ ids,
                                              long long j0, long long e,
                                              long long n, int vocab, int lane) {
  const long long j = j0 + lane;
  const bool in = j < e;
  int id = 0;
  bool st = false, en = false;
  if (in) {
    id = __ldg(ids + j);
    st = j == 0 || __ldg(ids + j - 1) != id;
    en = j == n - 1 || __ldg(ids + j + 1) != id;
  }
  RowFlags f;
  f.start = __ballot_sync(kFull, st);
  f.end = __ballot_sync(kFull, en);
  f.real = __ballot_sync(kFull, en && id < vocab);
  f.id = id;
  return f;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
count_kernel(const int* __restrict__ ids, long long n, int vocab,
             long long n_tiles, int* __restrict__ tile_cnt,
             int* __restrict__ tile_pass) {
  const long long tile =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (tile >= n_tiles) return;
  const int lane = threadIdx.x & 31;
  const long long s = tile * kTileRows;
  const long long e = s + kTileRows < n ? s + kTileRows : n;
  int cnt = 0;
  unsigned starts = 0;
  for (long long j0 = s; j0 < e; j0 += 32) {
    const RowFlags f = row_flags(ids, j0, e, n, vocab, lane);
    cnt += __popc(f.real);
    starts |= f.start;
  }
  if (lane == 0) {
    tile_cnt[tile] = cnt;
    tile_pass[tile] = starts == 0;  // the open run passes through the tile
  }
}

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ tile_cnt, int* __restrict__ tile_off,
            long long n_tiles, long long capr, int* __restrict__ total,
            int* __restrict__ overflow) {
  __shared__ int s[kScanThreads];
  const int tid = threadIdx.x;
  const long long per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const long long beg = tid * per;
  const long long end = beg + per < n_tiles ? beg + per : n_tiles;
  int local = 0;
  for (long long i = beg; i < end; ++i) local += tile_cnt[i];
  s[tid] = local;
  __syncthreads();
  for (int o = 1; o < kScanThreads; o <<= 1) {
    const int v = tid >= o ? s[tid - o] : 0;
    __syncthreads();
    s[tid] += v;
    __syncthreads();
  }
  int run = s[tid] - local;
  for (long long i = beg; i < end; ++i) {
    tile_off[i] = run;
    run += tile_cnt[i];
  }
  if (tid == kScanThreads - 1) {
    *total = s[tid];
    const long long over = static_cast<long long>(s[tid]) - capr;
    *overflow = over > 0 ? static_cast<int>(over) : 0;
  }
}

template <int kPerLane>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tile_kernel(const int* __restrict__ ids, const float* __restrict__ g,
            long long n, int dim, int vocab, long long capr,
            long long n_tiles, const int* __restrict__ tile_off,
            float* __restrict__ rows, int* __restrict__ tgt,
            float* __restrict__ tile_tail, int* __restrict__ tile_first) {
  const long long tile =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (tile >= n_tiles) return;
  const int lane = threadIdx.x & 31;
  const long long s = tile * kTileRows;
  const long long e = s + kTileRows < n ? s + kTileRows : n;
  float acc[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) acc[k] = 0.f;
  bool open = true;   // the current run began before this tile
  long long slot = tile_off[tile];
  long long first = -1;
  for (long long j0 = s; j0 < e; j0 += 32) {
    const RowFlags f = row_flags(ids, j0, e, n, vocab, lane);
    const int rows_here = static_cast<int>(e - j0 < 32 ? e - j0 : 32);
    for (int r0 = 0; r0 < rows_here; r0 += 8) {
      float v[8][kPerLane];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int d = lane + 32 * k;
          v[q][k] = (r0 + q < rows_here && d < dim)
                        ? __ldg(g + (j0 + r0 + q) * dim + d) : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int r = r0 + q;
        if (r >= rows_here) break;
        if ((f.start >> r) & 1u) {
          open = false;
#pragma unroll
          for (int k = 0; k < kPerLane; ++k) acc[k] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) acc[k] += v[q][k];
        if ((f.end >> r) & 1u) {
          if ((f.real >> r) & 1u) {
            const int id = __shfl_sync(kFull, f.id, r);
            if (slot < capr) {
#pragma unroll
              for (int k = 0; k < kPerLane; ++k) {
                const int d = lane + 32 * k;
                if (d < dim) rows[slot * kLanes + d] = acc[k];
              }
              if (lane == 0) tgt[slot] = id;
              if (open) first = slot;
            }
            ++slot;
          }
          open = false;
#pragma unroll
          for (int k = 0; k < kPerLane; ++k) acc[k] = 0.f;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int d = lane + 32 * k;
    if (d < dim) tile_tail[tile * dim + d] = acc[k];
  }
  if (lane == 0) tile_first[tile] = static_cast<int>(first);
}

// One block (thread d = dim d) per group: fold the group's tiles into one
// (pass, tail) pair: carry_out = pass ? carry_in + tail : tail.
__global__ void __launch_bounds__(kLanes)
group_kernel(const float* __restrict__ tile_tail,
             const int* __restrict__ tile_pass, long long n_tiles, int dim,
             float* __restrict__ group_tail, int* __restrict__ group_pass) {
  const int d = threadIdx.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * kGroupTiles;
  const long long t1 = t0 + kGroupTiles < n_tiles ? t0 + kGroupTiles : n_tiles;
  float c = 0.f;
  bool all = true;
#pragma unroll 8
  for (long long t = t0; t < t1; ++t) {
    const bool p = tile_pass[t] != 0;
    const float tail = d < dim ? tile_tail[t * dim + d] : 0.f;
    c = p ? c + tail : tail;
    all = all && p;
  }
  if (d < dim) group_tail[blockIdx.x * static_cast<long long>(dim) + d] = c;
  if (d == 0) group_pass[blockIdx.x] = all;
}

// One block: the carry each group inherits from the groups before it.
__global__ void __launch_bounds__(kLanes)
group_scan_kernel(const float* __restrict__ group_tail,
                  const int* __restrict__ group_pass, long long n_groups,
                  int dim, float* __restrict__ group_carry) {
  const int d = threadIdx.x;
  if (d >= dim) return;
  float c = 0.f;
#pragma unroll 8
  for (long long gi = 0; gi < n_groups; ++gi) {
    group_carry[gi * dim + d] = c;
    const float tail = group_tail[gi * dim + d];
    c = group_pass[gi] ? c + tail : tail;
  }
}

// One block per group: walk its tiles with the inherited carry and add it
// to the first slot of each tile whose first run began before the tile.
__global__ void __launch_bounds__(kLanes)
carry_kernel(const float* __restrict__ tile_tail,
             const int* __restrict__ tile_pass,
             const int* __restrict__ tile_first,
             const float* __restrict__ group_carry, long long n_tiles, int dim,
             float* __restrict__ rows) {
  const int d = threadIdx.x;
  if (d >= dim) return;
  const long long t0 = static_cast<long long>(blockIdx.x) * kGroupTiles;
  const long long t1 = t0 + kGroupTiles < n_tiles ? t0 + kGroupTiles : n_tiles;
  float c = group_carry[blockIdx.x * static_cast<long long>(dim) + d];
#pragma unroll 8
  for (long long t = t0; t < t1; ++t) {
    const int k = tile_first[t];
    if (k >= 0) rows[static_cast<long long>(k) * kLanes + d] += c;
    const float tail = tile_tail[t * dim + d];
    c = tile_pass[t] ? c + tail : tail;
  }
}

// One warp per slot: ‖Σg‖² into lane `dim`, zeros past it; junk slots
// get zero rows and target vocab + 1 + k.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
finish_kernel(float* __restrict__ rows, int* __restrict__ tgt, long long capr,
              int dim, int vocab, const int* __restrict__ total) {
  const long long k =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (k >= capr) return;
  const int lane = threadIdx.x & 31;
  float* row = rows + k * kLanes;
  if (k < *total) {
    float v[kLanes / 32];
    float sq = 0.f;
#pragma unroll
    for (int q = 0; q < kLanes / 32; ++q) {
      const int d = lane + 32 * q;
      v[q] = d < dim ? row[d] : 0.f;
      sq += v[q] * v[q];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(kFull, sq, o);
#pragma unroll
    for (int q = 0; q < kLanes / 32; ++q) {
      const int d = lane + 32 * q;
      if (d == dim) row[d] = sq;
      else if (d > dim) row[d] = 0.f;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kLanes / 32; ++q) row[lane + 32 * q] = 0.f;
    if (lane == 0) tgt[k] = static_cast<int>(vocab + 1 + k);
  }
}

unsigned blocks_for(long long items, long long per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

}  // namespace

// ints:   int32 scratch of 4 * n_tiles + n_groups + 1 entries;
// floats: f32 scratch of (n_tiles + 2 * n_groups) * dim entries;
// n_tiles = ceil(n / 128), n_groups = ceil(n_tiles / 128).
extern "C" int compact_runsums(const void* ids, const void* g, long long n,
                               int dim, int vocab, long long capr, void* tgt,
                               void* rows, void* overflow, void* ints,
                               void* floats, void* stream) {
  if (dim < 1 || dim >= kLanes - 1 || n <= 0 || capr <= 0)
    return cudaErrorInvalidValue;
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  const long long n_groups = (n_tiles + kGroupTiles - 1) / kGroupTiles;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* id = static_cast<const int*>(ids);
  const auto* gp = static_cast<const float*>(g);
  auto* tg = static_cast<int*>(tgt);
  auto* rw = static_cast<float*>(rows);
  int* tile_cnt = static_cast<int*>(ints);
  int* tile_off = tile_cnt + n_tiles;
  int* tile_pass = tile_off + n_tiles;
  int* tile_first = tile_pass + n_tiles;
  int* group_pass = tile_first + n_tiles;
  int* total = group_pass + n_groups;
  float* tile_tail = static_cast<float*>(floats);
  float* group_tail = tile_tail + n_tiles * dim;
  float* group_carry = group_tail + n_groups * dim;
  const dim3 warps(kWarpsPerBlock * 32);

  count_kernel<<<blocks_for(n_tiles, kWarpsPerBlock), warps, 0, s>>>(
      id, n, vocab, n_tiles, tile_cnt, tile_pass);
  scan_kernel<<<1, kScanThreads, 0, s>>>(tile_cnt, tile_off, n_tiles, capr,
                                         total, static_cast<int*>(overflow));
  const unsigned tb = blocks_for(n_tiles, kWarpsPerBlock);
  if (dim <= 32) {
    tile_kernel<1><<<tb, warps, 0, s>>>(id, gp, n, dim, vocab, capr, n_tiles,
                                        tile_off, rw, tg, tile_tail, tile_first);
  } else if (dim <= 64) {
    tile_kernel<2><<<tb, warps, 0, s>>>(id, gp, n, dim, vocab, capr, n_tiles,
                                        tile_off, rw, tg, tile_tail, tile_first);
  } else {
    tile_kernel<4><<<tb, warps, 0, s>>>(id, gp, n, dim, vocab, capr, n_tiles,
                                        tile_off, rw, tg, tile_tail, tile_first);
  }
  group_kernel<<<static_cast<unsigned>(n_groups), kLanes, 0, s>>>(
      tile_tail, tile_pass, n_tiles, dim, group_tail, group_pass);
  group_scan_kernel<<<1, kLanes, 0, s>>>(group_tail, group_pass, n_groups, dim,
                                         group_carry);
  carry_kernel<<<static_cast<unsigned>(n_groups), kLanes, 0, s>>>(
      tile_tail, tile_pass, tile_first, group_carry, n_tiles, dim, rw);
  finish_kernel<<<blocks_for(capr, kWarpsPerBlock), warps, 0, s>>>(
      rw, tg, capr, dim, vocab, total);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* compact_runsums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
