// One-pass read-modify-write row update: packed rows (K5) and grouped
// lines (K6).
//
// Replaces: goctr_tpu/ops/pallas/row_optimizer.py::_kernel /
// apply_row_updates (pallas_call at :176), K5, and ::_gline_kernel /
// apply_line_updates (pallas_call at :699), K6.
//
// Computes, in place, for every j with 0 <= ids[j] < skip_ge, on the
// 128-lane f32 line t = table[ids[j]] and its update row u = upd[j]:
//   adagrad: r = t + u·m_acc
//            t' = r − (lr · rsqrt(a + eps)) · u  on weight lanes, where a
//                 is r at the accumulator lane of the lane's group;
//            t' = r                              on every other lane
//   sgd:     t' = t − lr · u on weight lanes, t elsewhere
// m_w and m_acc are the weight and accumulator lane masks of a line of G
// (w | acc) groups of width d: G = 1 for K5 (w lanes < d, acc lane d),
// G = 128 / (d+1) for K6 (group g at lanes g·(d+1) … +d). Lanes past
// G·(d+1) are neither read nor written. Every product and sum is rounded
// on its own (__fmul_rn / __fadd_rn, never contracted into an fma), in
// the order of the JAX kernels (:110-116, :642-650) and of the plain
// version, so the two differ at most where rsqrtf does. The JAX kernels
// write r − scale·(u·m_w) on every lane, which is r wherever m_w = 0
// while scale is finite; taking r there directly also keeps those lanes
// finite at eps = 0. The JAX kernel spreads each group's accumulator
// over its weight lanes with a 0/1 matmul (one nonzero term per lane);
// here each warp puts a row's r in shared memory and every lane reads
// the accumulator lane of its group from there.
//
// ids of real rows are pairwise distinct (the trainer sums duplicates
// before), so no two warps touch one line and no atomics are needed. An
// id >= skip_ge (junk targets, which point past the table, and the other
// model shard's ids on a mesh) or < 0 is skipped before any address is
// formed; the caller keeps skip_ge <= the table's rows. Line offsets are
// 64-bit: the 100M × 16 lines are 7.3 GB.
//
// What bounds it on the H100: bytes. Each real row reads the 32-byte
// sectors of its line and of its update row that hold the G·(d+1) live
// lanes and writes the line's back; a skipped row costs its 4-byte id.
// At the 100M × 16 training step (576,909 real lines of 768,000 slots,
// 480 of 512 bytes live) that is ~0.83 GB, ~0.25 ms at 3.35 TB/s; at the
// 10M × 64 step (519,364 real rows of 596,992 slots, 288 of 512 bytes
// live) ~0.45 GB, ~0.135 ms. The arithmetic (a few flops a lane) is
// negligible. To stay near that bound the card needs ~2.3 MB in flight
// (3.35 TB/s × ~0.7 µs), ~18 KB an SM: 30-40 real rows' loads (576 B a
// K5 row, 960 B a K6 line).
//
// Design: the kernel is built for streams in which few slots are real
// as well as for dense ones. On a (data, model) mesh each model shard
// gets the whole merged d·cap stream (parallel/train.py, stage 4): 12%
// of its 2,162,688 slots are real for the headline on 2×2 and 14% for
// the 100M × 16 lines on 1×2, and those real slots sit together in one
// sorted stretch (this shard's ids), with the other shard's ids before
// or after it and stage 1's unused slots as a junk tail. The scanned
// trainer's streams are 75-87% real. A grid sized by slots with 4
// consecutive slots a warp (this kernel's first design) kept about half
// a real row in flight a warp on the mesh streams: most of its 67,584
// blocks read 128 ids and retired, and it took 2.3x (K5) and 1.8x (K6)
// the time it took on the same streams' real slots alone. So:
//   - the grid is persistent: the SM count times the blocks an SM holds
//     (cudaDeviceGetAttribute and the occupancy query, read once a card
//     and kept), never sized by a count of real rows;
//   - the stream is cut into chunks of 32 slots, dealt round the B
//     blocks: chunk b + B·j is block b's j-th. A stretch of real slots
//     thus spreads over every SM, and no block holds more than one chunk
//     beyond another;
//   - a block works through tiles of kTileChunks = 32 of its chunks
//     (1,024 slots), each warp loading 4 chunks' ids (one coalesced load
//     a chunk), the next tile's while this one's rows are updated. The
//     tile's real slots go into a list in shared memory (a ballot a
//     chunk, each warp's part after the counts of the warps before it);
//     a tile with no real slot costs its 4 KB of ids and three barriers;
//   - the block's warps take the list's entries kRowsInFlight = 2 at a
//     time in turn, so each warp gets as many real rows as the next,
//     whatever share of the slots is real. A warp issues the loads of
//     its next two rows (lane l holds lanes 4l … 4l+3 of a line as one
//     float4; lanes whose four lanes all lie past G·(d+1) load nothing)
//     before it updates and stores its current two.
// Registers hold the rows in flight (up to 4 rows, 8 float4 a lane);
// __launch_bounds__ asks for 4 blocks an SM (at most 64 registers a
// thread), so 32 warps an SM hold up to 128 rows, several times the ~40
// that the bytes in flight ask for, and no shared-memory ring is needed.
// Measured (scripts/rmw_sweep.py, H100): on the mesh streams the kernel
// takes within 2% of its own time on their real slots alone; on the
// scanned trainer's dense streams it runs 3-5% behind the first design's
// grid of short-lived blocks, as every persistent variant of the sweep
// does (2 or 4 rows a round, pipelined or not, tiles of 256 to 2,048
// slots). Its globaltimer build shows why: there every block holds the
// same count of real rows, yet the warps end over ~40 µs (K5; K6 ~80),
// and fewer than half are left for the last 10 µs (K6 12 µs), where the
// first design's short blocks leave that state within 1 µs of the end.
// That tail is as long as the whole gap: a static deal cannot move a
// slow SM's rows to an idle one.
// Plain version: apply_row_updates_plain / apply_line_updates_plain in
// goctr_tpu_torch/ops/kernels/row_optimizer.py (index_select, the same
// f32 terms in torch, index_put_).
#include <cuda_runtime.h>
#include <limits.h>

#include <atomic>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kChunks = 4;          // 32-slot chunks a warp loads a tile
constexpr int kTileChunks = kWarpsPerBlock * kChunks;
constexpr int kTileSlots = 32 * kTileChunks;
constexpr int kRowsInFlight = 2;    // real rows a warp loads a round
constexpr int kLanes = 128;         // floats per line: 32 lanes x float4
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// A block's shared memory: its tile's real slots as a list (ids and
// slots, in slot order within each warp's part), each warp's count of
// them, and each warp's rows in flight's r (adagrad), from which every
// lane reads the accumulator of its group.
struct BlockSmem {
  int id[kTileSlots];
  int slot[kTileSlots];
  int warp_count[kWarpsPerBlock];
  float4 r[kWarpsPerBlock][kRowsInFlight][32];
};

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The lanes a thread holds, 4l + k of each line: whether each is a
// weight lane, its accumulator mask and the lane of its group's
// accumulator. A thread with no live lane loads and stores nothing.
struct Lanes {
  bool live;
  bool is_w[4];
  float m_acc[4];
  int acc_at[4];
};

// kRowsInFlight rows of the block's list: their ids (-1: none) and the
// lanes of their lines and update rows that this thread holds.
struct Rows {
  int id[kRowsInFlight];
  float4 t[kRowsInFlight], u[kRowsInFlight];
};

// Issue the loads of entries r0 … r0 + kRowsInFlight − 1 of the list of
// `count`.
__device__ __forceinline__ void fetch(Rows& rows, const BlockSmem& sm,
                                      int r0, int count, const float* table,
                                      const float* upd, int lane, bool live) {
#pragma unroll
  for (int i = 0; i < kRowsInFlight; ++i) {
    const int at = r0 + i;
    rows.id[i] = at < count ? sm.id[at] : -1;
    rows.t[i] = rows.u[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (rows.id[i] < 0 || !live) continue;
    rows.t[i] = reinterpret_cast<const float4*>(
        table + static_cast<long long>(rows.id[i]) * kLanes)[lane];
    rows.u[i] = __ldg(reinterpret_cast<const float4*>(
                           upd + static_cast<long long>(sm.slot[at]) * kLanes) +
                       lane);
  }
}

// Update the fetched rows and store their lines; r is the warp's
// exchange buffer.
template <bool kAdagrad>
__device__ __forceinline__ void update(const Rows& rows,
                                       float4 (&r)[kRowsInFlight][32],
                                       const Lanes& ln, float* table,
                                       int lane, float lr, float eps) {
  if (kAdagrad) __syncwarp();          // the last round's r is read
#pragma unroll
  for (int i = 0; i < kRowsInFlight; ++i) {
    if (rows.id[i] < 0) continue;      // uniform across the warp
    const float4 t = rows.t[i], u = rows.u[i];
    float out[4];
    if (kAdagrad) {
      float ra[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        ra[k] = __fadd_rn(comp(t, k), __fmul_rn(comp(u, k), ln.m_acc[k]));
      r[i][lane] = make_float4(ra[0], ra[1], ra[2], ra[3]);
      __syncwarp();
      const float* r_lanes = reinterpret_cast<const float*>(r[i]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // on a weight lane the JAX kernels' products by m_w = 1 are exact
        const float scale =
            __fmul_rn(lr, rsqrtf(__fadd_rn(r_lanes[ln.acc_at[k]], eps)));
        out[k] = ln.is_w[k] ? __fsub_rn(ra[k], __fmul_rn(scale, comp(u, k)))
                            : ra[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        out[k] = ln.is_w[k] ? __fsub_rn(comp(t, k), __fmul_rn(lr, comp(u, k)))
                            : comp(t, k);
    }
    if (ln.live)
      reinterpret_cast<float4*>(
          table + static_cast<long long>(rows.id[i]) * kLanes)[lane] =
          make_float4(out[0], out[1], out[2], out[3]);
  }
}

// Chunk j of block b is b + B·j (B blocks): consecutive chunks go to
// consecutive blocks, and no block holds more than one chunk beyond
// another. Tile p of a block holds its chunks kTileChunks·p … +
// kTileChunks − 1, kChunks of them a warp; id[c] of a lane is slot
// chunk·32 + lane of the warp's chunk c (-1 past the stream).
__device__ __forceinline__ long long tile_chunk(long long p, int warp, int c) {
  return blockIdx.x + static_cast<long long>(gridDim.x) *
                          (kTileChunks * p + kChunks * warp + c);
}

__device__ __forceinline__ void load_ids(const int* __restrict__ ids,
                                         long long n, long long p, int warp,
                                         int lane, int (&id)[kChunks]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const long long j = tile_chunk(p, warp, c) * 32 + lane;
    id[c] = j < n ? __ldg(ids + j) : -1;
  }
}

template <bool kAdagrad>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 4)
rmw_kernel(float* __restrict__ table, const int* __restrict__ ids,
           const float* __restrict__ upd, long long n, long long skip_ge,
           int d, int group, float lr, float eps) {
  __shared__ BlockSmem sm;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const int width = d + 1;            // lanes of a (w | acc) group
  Lanes ln;
  ln.live = 4 * lane < group * width;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = 4 * lane + k;
    const bool within = c < group * width;
    const int r = c % width;
    ln.is_w[k] = within && r < d;
    ln.m_acc[k] = (within && r == d) ? 1.0f : 0.0f;
    ln.acc_at[k] = ln.is_w[k] ? c - r + d : c;
  }
  const long long n_chunks = (n + 31) / 32;
  int next[kChunks];
  load_ids(ids, n, 0, warp, lane, next);
  // uniform across the block: tile p exists if its first chunk does
  for (long long p = 0; tile_chunk(p, 0, 0) < n_chunks; ++p) {
    int cur[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) cur[c] = next[c];
    // the next tile's ids are in flight while this tile's rows are
    if (tile_chunk(p + 1, 0, 0) < n_chunks)
      load_ids(ids, n, p + 1, warp, lane, next);
    // the tile's real slots: this warp's part of the list starts after
    // the real slots of the warps before it
    unsigned m[kChunks];
    int mine = 0;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      m[c] = __ballot_sync(kFull, cur[c] >= 0 && cur[c] < skip_ge);
      mine += __popc(m[c]);
    }
    __syncthreads();                   // the last tile's list is read
    if (lane == 0) sm.warp_count[warp] = mine;
    __syncthreads();
    int at = 0, count = 0;
#pragma unroll
    for (int v = 0; v < kWarpsPerBlock; ++v) {
      const int k = sm.warp_count[v];
      at += v < warp ? k : 0;
      count += k;
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if ((m[c] >> lane) & 1u) {
        const int i = at + __popc(m[c] & below);
        sm.id[i] = cur[c];
        sm.slot[i] = static_cast<int>(tile_chunk(p, warp, c) * 32 + lane);
      }
      at += __popc(m[c]);
    }
    __syncthreads();
    // the warps take the list's entries kRowsInFlight at a time in turn;
    // one round's rows are updated while the next round's loads are in
    // flight
    constexpr int kStep = kWarpsPerBlock * kRowsInFlight;
    Rows rows;
    fetch(rows, sm, warp * kRowsInFlight, count, table, upd, lane, ln.live);
    for (int r0 = warp * kRowsInFlight; r0 < count; r0 += kStep) {
      Rows ahead;
      fetch(ahead, sm, r0 + kStep, count, table, upd, lane, ln.live);
      update<kAdagrad>(rows, sm.r[warp], ln, table, lane, lr, eps);
      rows = ahead;
    }
  }
}

// Blocks of rmw_kernel<kAdagrad> the current card holds at once: its SM
// count times the blocks an SM takes, read once a card and kept. Threads
// that launch at once may each read it the first time; they store the
// same number.
template <bool kAdagrad>
cudaError_t resident_blocks(int* out) {
  static std::atomic<int> held[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int blocks = held[dev].load(std::memory_order_relaxed);
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rmw_kernel<kAdagrad>, kWarpsPerBlock * 32, 0);
    if (e != cudaSuccess) return e;
    if (sms * per_sm <= 0) return cudaErrorInvalidConfiguration;
    blocks = sms * per_sm;
    held[dev].store(blocks, std::memory_order_relaxed);
  }
  *out = blocks;
  return cudaSuccess;
}

template <bool kAdagrad>
int launch_kind(float* table, const int* ids, const float* upd, long long n,
                long long skip_ge, int d, int group, float lr, float eps,
                cudaStream_t s) {
  int resident = 0;
  const cudaError_t e = resident_blocks<kAdagrad>(&resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  // no more blocks than give every block a tile
  const long long n_chunks = (n + 31) / 32;
  const long long wanted = (n_chunks + kTileChunks - 1) / kTileChunks;
  const dim3 grid(static_cast<unsigned>(wanted < resident ? wanted : resident));
  rmw_kernel<kAdagrad><<<grid, kWarpsPerBlock * 32, 0, s>>>(
      table, ids, upd, n, skip_ge, d, group, lr, eps);
  return static_cast<int>(cudaGetLastError());
}

int launch(void* table, const void* ids, const void* upd, long long n,
           long long skip_ge, int d, bool grouped, int adagrad, float lr,
           float eps, void* stream) {
  // slots are held as int in shared memory: n <= INT_MAX (1 TB of update
  // rows)
  if (d <= 0 || d >= kLanes || n > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int group = grouped ? kLanes / (d + 1) : 1;
  auto* t = static_cast<float*>(table);
  const auto* i = static_cast<const int*>(ids);
  const auto* u = static_cast<const float*>(upd);
  auto s = static_cast<cudaStream_t>(stream);
  if (adagrad)
    return launch_kind<true>(t, i, u, n, skip_ge, d, group, lr, eps, s);
  return launch_kind<false>(t, i, u, n, skip_ge, d, group, lr, eps, s);
}

}  // namespace

// K5: packed [V, 128] f32 rows (w | acc | 0), one group per line.
// table, ids [n] int32, upd [n, 128] f32 16-byte aligned; skip_ge <= V.
extern "C" int row_rmw(void* table, const void* ids, const void* upd,
                       long long n, long long skip_ge, int d, int adagrad,
                       float lr, float eps, void* stream) {
  return launch(table, ids, upd, n, skip_ge, d, false, adagrad, lr, eps,
                stream);
}

// K6: grouped [L, 128] f32 lines, G = 128 / (d+1) groups per line;
// skip_ge <= L.
extern "C" int line_rmw(void* table, const void* ids, const void* upd,
                        long long n, long long skip_ge, int d, int adagrad,
                        float lr, float eps, void* stream) {
  return launch(table, ids, upd, n, skip_ge, d, true, adagrad, lr, eps,
                stream);
}

extern "C" const char* row_rmw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
