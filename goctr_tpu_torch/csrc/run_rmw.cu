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
// are never used (a copy may take the few bytes of a neighbour's row that
// share a 16-byte word with a real row when d is not a multiple of 4).
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
//              open run's sum in registers (thread l holds dims 4l … 4l+3).
//              A real run that starts and ends in the tile is updated by
//              this warp (kLinesInFlight lines at a time); the tile
//              leaves the sum of
//              the run still open at its end (its tail), whether a run
//              starts in it (pass = no start), and, when its first run
//              began before it and ends in it, that run's id and its part
//              of the sum (the head);
//   2-4. carry: the sum each tile inherits from runs that began before it
//              is a segmented scan of the tails (a run start cuts it):
//              one block per group of 128 tiles folds the group, one
//              block scans the groups, and one block per group walks its
//              tiles again and adds the inherited sum to each head;
//   5. heads:  one warp per kBatch tiles updates their heads' lines.
// The tile pass takes most of the time, and it waits on memory latency,
// not on bytes or arithmetic: a warp that loads its own g rows a few at a
// time and stops for every batch of line loads keeps too little in
// flight. So the tile pass (one warp a tile, 4 warps a block)
//   - reads the tile's 128 + 2 ids once (four coalesced loads a lane, the
//     neighbours by shuffle);
//   - streams the real rows of each 32-row part through a ring of
//     kStages stages of shared memory a warp, one cp.async.bulk copy a
//     part (bulk_copy.cuh), so that the next part's rows arrive while the
//     warp sums this one; a part with no real rows copies nothing;
//   - sums a part's rows from shared memory, and parks each finished
//     run's Σg in its last row's place in the stage;
//   - then issues the loads of the part's finished lines, up to
//     kLinesInFlight at once (their Σg into registers), and updates them
//     only after the next part's rows are summed, so that their latency
//     is hidden behind that work.
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
#include <stdint.h>

#include "bulk_copy.cuh"
#include "line_update.cuh"

namespace {

using line_update::Batch;
using line_update::kBatch;
using line_update::kFull;

constexpr int kTileRows = 128;     // rows per warp tile (run_optimizer.py: TILE_ROWS)
constexpr int kGroupTiles = 128;   // tiles per carry group (GROUP_TILES)
constexpr int kWarpsPerBlock = 8;  // the heads pass
constexpr int kLanes = line_update::kLanes;
constexpr int kParts = kTileRows / 32;  // 32-row parts a tile: a ring unit each
constexpr int kTileWarps = 4;      // warps a block of the tile pass
constexpr int kStages = 2;         // ring stages a warp
constexpr int kLinesInFlight = 8;  // finished runs a warp holds while
                                   // their lines' loads are in flight
static_assert(kParts == 4 && kStages <= kParts, "tile layout");

// Bytes of a stage: a part's 32 rows of d floats, 16 bytes of slack at
// each end (a copy starts and ends on 16 bytes), rounded up to 128; a
// warp's shared memory is kStages stages, then its kStages mbarriers.
int stage_bytes(int d) { return (32 * d * 4 + 32 + 127) / 128 * 128; }
int warp_smem(int d) { return kStages * stage_bytes(d) + 128; }

struct TileArgs {
  float* table;
  const int* ids;
  const float* g;
  long long n;
  int d;
  long long skip_ge;
  float lr, eps;
  long long n_tiles;
  float* tile_tail;
  int* tile_pass;
  float* head;
  int* head_id;
  int stage_bytes, warp_smem;
};

// A tile's ids as a lane holds them: rows s + 32i + lane (i < kParts);
// `edge` is ids[s − 1] in lane 0 and ids[s + kTileRows] in lane 31, where
// they exist.
struct TileIds {
  int id[kParts];
  int edge;
};

// id[i] for a part index the code does not know at compile time, with
// no local memory
__device__ __forceinline__ int pick(const int (&v)[kParts], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

__device__ __forceinline__ void load_ids(const TileArgs& a, long long tile,
                                         int lane, TileIds& t) {
  const long long s = tile * kTileRows;
  const bool live = tile < a.n_tiles;
#pragma unroll
  for (int i = 0; i < kParts; ++i) {
    const long long j = s + 32 * i + lane;
    t.id[i] = live && j < a.n ? __ldg(a.ids + j) : 0;
  }
  const long long je = lane == 0 ? s - 1 : s + kTileRows;
  t.edge = live && (lane == 0 || lane == 31) && je >= 0 && je < a.n
               ? __ldg(a.ids + je) : 0;
}

// This lane's row of part p of `tile`: whether it lies in the ids,
// starts a run, ends one, and is real (its id in [0, skip_ge)). Every
// lane calls it (it shuffles): the ids before and after a row are the
// neighbouring lane's, across a part's edges the neighbouring part's
// last or first, across the tile's edges `edge`.
struct RowFlags {
  bool start, end, real;
};

__device__ __forceinline__ RowFlags row_flags(const TileArgs& a,
                                              long long tile,
                                              const TileIds& t, int p,
                                              int lane) {
  const long long j = tile * kTileRows + 32 * p + lane;
  const int id = pick(t.id, p);
  const int before = __shfl_sync(kFull, t.edge, 0);
  const int after = __shfl_sync(kFull, t.edge, 31);
  const int prev_last = __shfl_sync(kFull, pick(t.id, p > 0 ? p - 1 : 0), 31);
  const int next_first =
      __shfl_sync(kFull, pick(t.id, p + 1 < kParts ? p + 1 : p), 0);
  int prev = __shfl_up_sync(kFull, id, 1);
  int next = __shfl_down_sync(kFull, id, 1);
  if (lane == 0) prev = p > 0 ? prev_last : before;
  if (lane == 31) next = p + 1 < kParts ? next_first : after;
  const bool valid = j < a.n;
  RowFlags f;
  f.start = valid && (j == 0 || prev != id);
  f.end = valid && (j == a.n - 1 || next != id);
  f.real = valid && id >= 0 && id < a.skip_ge;
  return f;
}

// Which rows of part p are real: a warp ballot.
__device__ __forceinline__ unsigned real_rows(const TileArgs& a,
                                              long long tile,
                                              const TileIds& t, int p,
                                              int lane) {
  const long long j = tile * kTileRows + 32 * p + lane;
  const int id = pick(t.id, p);
  return __ballot_sync(kFull, j < a.n && id >= 0 && id < a.skip_ge);
}

// The warp's ring: part p of its tile lands in stage p % kStages. Lane 0
// issues; every lane waits.
struct Ring {
  unsigned char* stages;
  uint64_t* bars;
  const float* g;
  int d, stage_bytes;

  // the bytes of part `part` of `tile` whose real rows are `in` (not 0):
  // from its first real row to the end of its last, widened to 16 bytes
  __device__ void span(long long tile, int part, unsigned in, uintptr_t& b0,
                       uintptr_t& b1) const {
    const long long r = tile * kTileRows + 32 * part;
    const uintptr_t g0 = reinterpret_cast<uintptr_t>(g);
    const long long row_bytes = 4ll * d;
    b0 = (g0 + (r + __ffs(in) - 1) * row_bytes) & ~uintptr_t(15);
    b1 = (g0 + (r + 32 - __clz(in)) * row_bytes + 15) & ~uintptr_t(15);
  }
  __device__ void issue(long long tile, int part, unsigned in) const {
    const int st = part % kStages;
    if (in == 0) {
      bulk_copy::mbar_arrive(bars + st);
      return;
    }
    uintptr_t b0, b1;
    span(tile, part, in, b0, b1);
    bulk_copy::bulk_load(stages + st * stage_bytes,
                         reinterpret_cast<const void*>(b0),
                         static_cast<uint32_t>(b1 - b0), bars + st);
  }
  // once the part has landed: its stage, and the byte offset in it of row
  // r of the part is delta + 4·d·r (for the part's real rows)
  __device__ const unsigned char* wait(long long tile, int part, unsigned in,
                                       long long& delta) const {
    const int st = part % kStages;
    bulk_copy::mbar_wait(bars + st,
                         static_cast<uint32_t>((part / kStages) & 1));
    delta = 0;
    if (in != 0) {
      uintptr_t b0, b1;
      span(tile, part, in, b0, b1);
      delta = static_cast<long long>(
          reinterpret_cast<uintptr_t>(g) +
          (tile * kTileRows + 32 * part) * 4ull * d - b0);
    }
    return stages + st * stage_bytes;
  }
};

// This thread's dims 4·lane … 4·lane + 3 of the row at shared address
// `row` of a stage (0 past d), and their store back into it. The stage's
// address is taken explicitly (ld/st.shared), so that no access goes
// through a generic address.
template <bool kVec>
__device__ __forceinline__ void load_dims(uint32_t row, int d, int lane,
                                          float (&v)[4]) {
  if constexpr (kVec) {
    if (4 * lane < d)
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                   : "r"(row + 16 * lane));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * lane + k < d)
        asm volatile("ld.shared.f32 %0, [%1];\n"
                     : "=f"(v[k]) : "r"(row + 4 * (4 * lane + k)));
  }
}

template <bool kVec>
__device__ __forceinline__ void store_dims(uint32_t row, int d, int lane,
                                           const float (&v)[4]) {
  if constexpr (kVec) {
    if (4 * lane < d)
      asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(row + 16 * lane), "f"(v[0]), "f"(v[1]), "f"(v[2]),
                      "f"(v[3])
                   : "memory");
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * lane + k < d)
        asm volatile("st.shared.f32 [%0], %1;\n"
                     :: "r"(row + 4 * (4 * lane + k)), "f"(v[k]) : "memory");
  }
}

// A warp's line updates in flight: up to kLinesInFlight finished runs
// (their ids and this thread's dims of Σg) whose lines' loads were issued
// when their part's rows were summed, and are updated after the next
// part's rows, so that the loads land meanwhile. A warp's runs are
// distinct lines, so an update never waits on another.
template <bool kAdagrad, bool kVec>
struct Pending {
  int n;                                       // the same in every lane
  int id[kLinesInFlight];
  float g[kLinesInFlight][4];
  float4 t[kLinesInFlight];

  __device__ void update(const TileArgs& a, int lane) {
#pragma unroll
    for (int i = 0; i < kLinesInFlight; ++i) {
      if (i >= n) break;
      line_update::update_line<kAdagrad>(a.table, id[i], t[i], g[i], a.d,
                                         a.lr, a.eps, lane);
    }
    n = 0;
  }
  // Take up to kLinesInFlight runs of `done` (rows of a part whose row r
  // holds its run's Σg at shared address row0 + 4·d·r, ids `ids` in the
  // part's lanes) and issue their lines' loads.
  __device__ void take(const TileArgs& a, unsigned& done, uint32_t row0,
                       int ids, int lane) {
#pragma unroll
    for (int i = 0; i < kLinesInFlight; ++i) {
      const int r = done != 0 ? __ffs(done) - 1 : -1;
      done &= done - 1;
      id[i] = __shfl_sync(kFull, ids, r < 0 ? 0 : r);
#pragma unroll
      for (int k = 0; k < 4; ++k) g[i][k] = 0.f;
      if (r >= 0) {
        load_dims<kVec>(row0 + 4 * a.d * r, a.d, lane, g[i]);
        t[i] = line_update::load_line(a.table, id[i], a.d, lane);
        ++n;
      }
    }
  }
};

// The tile pass: one warp a tile. kVec: d % 4 == 0 and g on 16 bytes, so
// that every row of a stage is on 16 bytes too.
template <bool kAdagrad, bool kVec>
__global__ void __launch_bounds__(kTileWarps * 32)
tile_kernel(const __grid_constant__ TileArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile = static_cast<long long>(blockIdx.x) * kTileWarps + warp;
  if (tile >= a.n_tiles) return;
  unsigned char* base = smem + warp * a.warp_smem;
  const Ring ring{base,
                  reinterpret_cast<uint64_t*>(base + kStages * a.stage_bytes),
                  a.g, a.d, a.stage_bytes};
  const int d = a.d;
  TileIds ids;
  load_ids(a, tile, lane, ids);
  if (lane == 0) {
    for (int st = 0; st < kStages; ++st) bulk_copy::mbar_init(ring.bars + st);
    bulk_copy::fence_mbar_init();
  }
  for (int p = 0; p < kStages; ++p) {
    const unsigned in = real_rows(a, tile, ids, p, lane);
    if (lane == 0) ring.issue(tile, p, in);
  }
  __syncwarp();
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float h[4] = {0.f, 0.f, 0.f, 0.f};
  int h_id = -1;
  bool open = true;  // the current run began before this tile
  bool any_start = false;
  Pending<kAdagrad, kVec> lines;
  lines.n = 0;
#pragma unroll 1
  for (int p = 0; p < kParts; ++p) {
    const RowFlags f = row_flags(a, tile, ids, p, lane);
    const unsigned in = __ballot_sync(kFull, f.real);
    const unsigned starts = __ballot_sync(kFull, f.start);
    const unsigned ends = __ballot_sync(kFull, f.end);
    const unsigned reals = in & ends;
    const int id = pick(ids.id, p);
    any_start = any_start || starts != 0;
    long long delta;
    const unsigned char* stage = ring.wait(tile, p, in, delta);
    // row r of the part is at shared address row0 + 4·d·r
    const uint32_t row0 = static_cast<uint32_t>(
        bulk_copy::smem_addr(stage) + delta);
    const long long left = a.n - (tile * kTileRows + 32 * p);
    const int rows_here = left < 32 ? static_cast<int>(left) : 32;
    // Sum the part's rows in order. A run that ends here and began in
    // this tile leaves its sum in its last row's place in the stage (a
    // row already read); the tile's head run keeps its sum in h.
    unsigned done = 0;
#pragma unroll 4
    for (int r = 0; r < rows_here; ++r) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if ((in >> r) & 1u) load_dims<kVec>(row0 + 4 * d * r, d, lane, v);
      if ((starts >> r) & 1u) {
        open = false;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], v[k]);
      if ((ends >> r) & 1u) {
        if ((reals >> r) & 1u) {
          if (open) {  // the run began before this tile: finish it later
            h_id = __shfl_sync(kFull, id, r);
#pragma unroll
            for (int k = 0; k < 4; ++k) h[k] = acc[k];
          } else {
            store_dims<kVec>(row0 + 4 * d * r, d, lane, acc);
            done |= 1u << r;
          }
        }
        open = false;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = 0.f;
      }
    }
    // the last part's lines, loaded while these rows were summed; then
    // this part's, whose loads are in flight while the next part's rows
    // are (its Σg leaves the stage for registers before the stage is
    // refilled)
    lines.update(a, lane);
    while (true) {
      lines.take(a, done, row0, id, lane);
      if (done == 0) break;
      lines.update(a, lane);    // more than kLinesInFlight runs ended here
    }
    // the stage is read: refill it with part p + kStages
    if (p + kStages < kParts) {
      const unsigned in_q = real_rows(a, tile, ids, p + kStages, lane);
      __syncwarp();
      if (lane == 0) ring.issue(tile, p + kStages, in_q);
    }
  }
  lines.update(a, lane);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dim = 4 * lane + k;
    if (dim < d) {
      a.tile_tail[tile * d + dim] = acc[k];
      a.head[tile * d + dim] = h[k];
    }
  }
  if (lane == 0) {
    a.tile_pass[tile] = !any_start;  // the open run passes through
    a.head_id[tile] = h_id;
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

template <bool kAdagrad, bool kVec>
cudaError_t launch_tiles(const TileArgs& a, cudaStream_t s) {
  auto* kernel = tile_kernel<kAdagrad, kVec>;
  const int smem = kTileWarps * a.warp_smem;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks_for(a.n_tiles, kTileWarps), kTileWarps * 32, smem, s>>>(a);
  return cudaGetLastError();
}

template <bool kAdagrad>
cudaError_t launch_all(const TileArgs& a, long long n_groups, int* group_pass,
                       float* group_tail, float* group_carry, cudaStream_t s) {
  const bool vec =
      a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.g) % 16 == 0;
  const cudaError_t e = vec ? launch_tiles<kAdagrad, true>(a, s)
                            : launch_tiles<kAdagrad, false>(a, s);
  if (e != cudaSuccess) return e;
  const int d = a.d;
  group_kernel<<<static_cast<unsigned>(n_groups), kLanes, 0, s>>>(
      a.tile_tail, a.tile_pass, a.n_tiles, d, group_tail, group_pass);
  group_scan_kernel<<<1, kLanes, 0, s>>>(group_tail, group_pass, n_groups, d,
                                         group_carry);
  carry_kernel<<<static_cast<unsigned>(n_groups), kLanes, 0, s>>>(
      a.tile_tail, a.tile_pass, a.head_id, group_carry, a.n_tiles, d, a.head);
  heads_kernel<kAdagrad><<<blocks_for(a.n_tiles, kWarpsPerBlock * kBatch),
                           kWarpsPerBlock * 32, 0, s>>>(
      a.table, a.head, a.head_id, a.n_tiles, d, a.lr, a.eps);
  return cudaGetLastError();
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
  TileArgs a;
  a.table = static_cast<float*>(table);
  a.ids = static_cast<const int*>(ids);
  a.g = static_cast<const float*>(g);
  a.n = n;
  a.d = d;
  a.skip_ge = skip_ge;
  a.lr = lr;
  a.eps = eps;
  a.n_tiles = (n + kTileRows - 1) / kTileRows;
  a.stage_bytes = stage_bytes(d);
  a.warp_smem = warp_smem(d);
  const long long n_groups = (a.n_tiles + kGroupTiles - 1) / kGroupTiles;
  a.tile_pass = static_cast<int*>(ints);
  a.head_id = a.tile_pass + a.n_tiles;
  int* group_pass = a.head_id + a.n_tiles;
  a.tile_tail = static_cast<float*>(floats);
  a.head = a.tile_tail + a.n_tiles * d;
  float* group_tail = a.head + a.n_tiles * d;
  float* group_carry = group_tail + n_groups * d;
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      adagrad ? launch_all<true>(a, n_groups, group_pass, group_tail,
                                 group_carry, s)
              : launch_all<false>(a, n_groups, group_pass, group_tail,
                                  group_carry, s);
  return static_cast<int>(e);
}

extern "C" const char* run_rmw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
