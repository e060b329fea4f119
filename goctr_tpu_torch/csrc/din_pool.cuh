// What the DIN pool's forward (K2, din_attention.cu) and backward (K2b,
// din_attention_bwd.cu) share: the plan of a launch, lane groups, the
// per-warp ring of bulk copies, and group sums.
//
// Both kernels stream behaviors [B, T, D] once (K2b also writes
// d_behaviors once); everything else they read is small. What bounds them
// on the H100 is bytes, so the design keeps many bytes in flight with
// 16-byte accesses and short reductions:
//
// Lane groups. A behavior row of D·s bytes (s = 2 for bf16, 4 for f32) is
// held by a group of L = min(32, next pow2 of D·s/16) lanes, each with KC
// 16-byte vectors (vector v of the row at lane v % L; KC = 1 up to 512 B,
// 2 up to 1 KB, so a row past 512 B is two chunks with the group's sums
// carried across them). One warp instruction covers 32 / L rows: 4 at
// D = 64 bf16, 16 at D = 16 bf16. A row's sums take log2 L shuffle rounds.
//
// The ring. Each warp streams its rows through kStages stages of shared
// memory with Hopper's 1-D bulk copy (cp.async.bulk ... mbarrier::
// complete_tx, bulk_copy.cuh), issued by lane 0 and completed on one
// mbarrier a stage;
// while one stage is reduced the next kStages - 1 are in flight (4 KB a
// warp at two stages of 4 KB, 8 KB while a warp waits; 16 warps an SM;
// two stages measured a few per cent faster than three). A stage is a
// unit: P whole batch rows when T·D·s fits a stage (P = 4 at D = 16
// bf16, T = 32), else one T-tile of one batch row.
//
// The persistent grid. min(kBlocksPerSM · SMs, what the jobs need) blocks
// of kWarps warps (fewer if fewer fit the SMs at once); a job is P
// consecutive batch rows, and warp slot w takes jobs w, w + W, w + 2W, ...
// (W slots in all) in that order, so whatever a warp sums over its rows is
// summed in a fixed order. A cursor walks the units without divisions.
//
// Latency. A warp takes U rows a group at a time (U·32/L rows a warp
// instruction) and, where a batch row has fewer rows than that, Q batch
// rows at once (Q sets of groups); the U rows' loads, sums and per-row
// scalars are independent, so their latencies overlap. Up to 4 rows stay
// in registers between the sums and their use, 8 (rows of at most 32
// bytes) are read again from shared memory. The scalars use branch-free
// approximate
// reciprocals and exp2, which a branch to a slow path (IEEE '/',
// __frcp_rn) would serialise. The next unit's small rows (mask, item,
// dout) are prefetched into L1 while a unit is reduced.
//
// Rows whose bytes are not a multiple of 16, pointers not 16-byte aligned,
// or rows over 1 KB take the kernels' generic path (kc = 0): one warp a
// batch row, plain element loads from global memory, outputs in chunks of
// 256 elements (8 a lane), the row sums recomputed for each chunk.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace din_pool {

using namespace bulk_copy;

constexpr int kWarps = 4;           // warps a block
constexpr int kBlocksPerSM = 4;     // persistent blocks an SM
constexpr int kStages = 2;          // ring stages a warp
constexpr int kStageBytes = 4096;   // bytes a stage
// rows a group takes at once, at most: 4 at one vector a lane, 8 for rows
// of at most 32 bytes (little work a row), 2 at two vectors; fewer where
// a batch row's rows would not fill the trip
constexpr int kRowsKC1 = 4;
constexpr int kRowsSmall = 8;
constexpr int kRowsKC2 = 2;
// K2b's per-warp d_att0 sums: one a row of the most rows a stage holds
constexpr int kAttFloats = kStageBytes / 16;
constexpr int kGenericChunk = 256;  // generic path: outputs a pass
constexpr int kGenericPerLane = kGenericChunk / 32;
// per-warp shared memory: stages, d_att0 sums, then 128 bytes for one
// mbarrier a stage (so that every warp's stages stay 128-byte aligned)
constexpr int kWarpSmem = kStages * kStageBytes + kAttFloats * 4 + 128;
static_assert(kWarpSmem % 128 == 0 && kStages * 8 <= 128, "smem layout");
constexpr float kEps = 1e-8f;

// ---------------------------------------------------------------- plan --
// (the grid is capped again at launch by the kernel's measured occupancy,
// so that every block of the persistent grid is resident at once)
struct Plan {
  int kc;             // 16-B vectors a lane per row (1, 2); 0 = generic
  int lanes;          // L, lanes of a group
  int rows_at_once;   // U, rows a group takes a trip (1, 2, 4, 8)
  int rows_together;  // Q, batch rows a warp takes at once (G / Q groups
                      // each)
  int vec_per_row;    // 16-B vectors in a row
  int rows_per_job;   // P, batch rows of a job
  int tile;           // rows of a unit (a T-tile when ntile > 1)
  int ntile;          // units a job
  long long n_jobs;
  int grid;           // blocks
  size_t smem;        // dynamic shared memory a block
};

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// `fast`: every row pointer the kernel reads or writes is 16-B aligned
inline Plan make_plan(long long batch, int seq, int dim, int elem_bytes,
                      bool fast, int n_sms) {
  Plan p{};
  const long long row_bytes = static_cast<long long>(dim) * elem_bytes;
  if (fast && row_bytes % 16 == 0 && row_bytes <= 1024) {
    p.vec_per_row = static_cast<int>(row_bytes / 16);
    p.lanes = 1;
    while (p.lanes < p.vec_per_row && p.lanes < 32) p.lanes <<= 1;
    p.kc = (p.vec_per_row + p.lanes - 1) / p.lanes;
    const int stage_rows = static_cast<int>(kStageBytes / row_bytes);
    if (seq <= stage_rows) {
      p.rows_per_job = stage_rows / seq;
      p.tile = seq;
      p.ntile = 1;
    } else {
      p.rows_per_job = 1;
      p.tile = stage_rows;
      p.ntile = (seq + stage_rows - 1) / stage_rows;
    }
    // U rows a group a trip, over Q batch rows at once, so that a trip's
    // U·32/L rows fill the unit's batch rows with little left idle
    const int groups = 32 / p.lanes;
    const int seg_rows = seq < p.tile ? seq : p.tile;
    p.rows_at_once = p.kc == 2 ? kRowsKC2 : p.lanes <= 2 ? kRowsSmall
                                                          : kRowsKC1;
    p.rows_together = 1;
    while (p.rows_together * 2 <= groups &&
           p.rows_together * 2 <= p.rows_per_job &&
           p.rows_at_once * groups / (p.rows_together * 2) >= seg_rows)
      p.rows_together *= 2;
    while (p.rows_at_once > 1 &&
           p.rows_at_once * (groups / p.rows_together) > seg_rows)
      p.rows_at_once >>= 1;
    p.smem = static_cast<size_t>(kWarps) * kWarpSmem;
  } else {
    p.kc = 0;
    p.lanes = 32;
    p.rows_at_once = 1;
    p.rows_together = 1;
    p.rows_per_job = 1;
    p.tile = seq;
    p.ntile = 1;
    p.smem = 0;
  }
  p.n_jobs = (batch + p.rows_per_job - 1) / p.rows_per_job;
  const long long want = (p.n_jobs + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(kBlocksPerSM) * n_sms;
  p.grid = static_cast<int>(want < cap ? want : cap);
  return p;
}

// ------------------------------------------------------------ vectors --
// Before a launch: let `kernel` take the plan's shared memory, and cap the
// plan's grid at the blocks that fit on the card at once.
template <typename K>
cudaError_t fit(K* kernel, Plan& p, int n_sms) {
  cudaError_t e = cudaSuccess;
  if (p.smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p.smem));
    if (e != cudaSuccess) return e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kWarps * 32, p.smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long cap = static_cast<long long>(per_sm) * n_sms;
  if (p.grid > cap) p.grid = static_cast<int>(cap);
  return cudaSuccess;
}

template <typename T>
struct Vec;  // VEC elements of T in 16 bytes, as floats

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void two(uint32_t w, float* v) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ void unpack(const uint4& r, float* v) {
    two(r.x, v);
    two(r.y, v + 2);
    two(r.z, v + 4);
    two(r.w, v + 6);
  }
  static __device__ __forceinline__ uint32_t two(const float* v) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(two(v), two(v + 2), two(v + 4), two(v + 6));
  }
};

// Row r of a segment in a stage as this lane's KC vectors (lane gl of its
// group holds vectors gl, gl + L, ...): zeros past the row's nvec vectors
// or where `valid` is false.
template <typename T, int KC>
__device__ __forceinline__ void load_row(const T* seg, int r, int dim,
                                         int gl, int lanes, int nvec,
                                         bool valid,
                                         float (&bv)[KC][Vec<T>::kN]) {
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int v = gl + k * lanes;
    if (valid && v < nvec) {
      Vec<T>::unpack(*reinterpret_cast<const uint4*>(
                         seg + static_cast<long long>(r) * dim +
                         v * Vec<T>::kN), bv[k]);
    } else {
#pragma unroll
      for (int e = 0; e < Vec<T>::kN; ++e) bv[k][e] = 0.f;
    }
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Sum over the lanes of a group of L (xor offsets L/2 ... 1).
template <typename A>
__device__ __forceinline__ A group_sum(A v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the groups of a warp's aligned sets of `span` lanes (xor
// offsets L ... span / 2): every lane ends with the sum of its position's
// values over the span / L groups of its set.
template <typename A>
__device__ __forceinline__ A across_groups(A v, int lanes, int span = 32) {
  for (int o = lanes; o < span; o <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// K2b's working type: f32 for bf16 inputs; f64 for f32 inputs. A zero
// item row's d_item (~1/eps) is a sum over t of terms that cancel, so
// that a few f32 roundings more or less in each term move it by ~1e-5 of
// itself, more than an f32 gradient is held to; computed in f64, it lies
// within the plain version's own f32 rounding of the exact value.
template <typename T>
struct Acc {
  using type = float;
};
template <>
struct Acc<float> {
  using type = double;
};

__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }
// f32: the hardware's approximate reciprocal (no branch, so that the U
// rows' scalar chains interleave; __frcp_rn and '/' branch to a slow path)
__device__ __forceinline__ float rcp_(float x) { return __fdividef(1.f, x); }
__device__ __forceinline__ double rcp_(double x) { return 1.0 / x; }
__device__ __forceinline__ float exp_(float x) { return __expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }

// K2b's per-t scalars of one behavior row from its sums ⟨b,i⟩, |b|² and
// ⟨dout,b⟩, its mask m and att0 a, the item norm ni and 1 / M (the
// formulas of din_attention_bwd.cu, with reciprocals taken once).
template <typename A>
struct RowGrad {
  A gmm, ddot, cb;   // d_b = gmm·dout + ddot·i + cb·b; d_i += ddot·b
  A dden_nb;         // dden·nb, summed over t for d_i's norm term
  A att;             // dz·w, summed over rows for d_att0
};

template <typename A>
__device__ __forceinline__ RowGrad<A> row_grad(A dot, A bb, A gb, float m,
                                               float a, A ni, A rden_m) {
  const A e2 = A(kEps * kEps);   // the f32 clamp, as the plain version
  const A bbc = bb > e2 ? bb : e2;
  const A rnb = rsqrt_(bbc);
  const A nb = bbc * rnb;
  const A rden = rcp_(nb * ni + A(kEps));
  const A cosv = dot * rden;
  const A w = (cosv + A(1)) * A(0.5);
  const A gate = rcp_(A(1) + exp_(-(w * a)));
  const A dz = gb * rden_m * m * gate * (A(1) - gate);
  const A dcos = dz * a * A(0.5);
  const A dden = -dcos * cosv * rden;
  RowGrad<A> r;
  r.gmm = gate * m * rden_m;
  r.ddot = dcos * rden;
  r.cb = bb > e2 ? dden * ni * rnb : A(0);
  r.dden_nb = dden * nb;
  r.att = dz * w;
  return r;
}

// ---------------------------------------------------------------- ring --
// All lanes: prefetch the 128-byte lines of [p, p + bytes) into L1, so
// that a unit's small reads (mask, item and dout rows) are there when the
// unit before it is done.
__device__ __forceinline__ void prefetch_l1(const void* p, long long bytes,
                                            int lane) {
  const uintptr_t first = reinterpret_cast<uintptr_t>(p) & ~uintptr_t(127);
  const uintptr_t end = reinterpret_cast<uintptr_t>(p) + bytes;
  for (uintptr_t q = first + 128 * lane; q < end; q += 128 * 32)
    asm volatile("prefetch.global.L1 [%0];\n" :: "l"(q));
}

// A unit: batch rows [b, b + nb) at positions [t0, t1) of T, contiguous
// in [B·T, D] from flattened row b·T + t0 (whole rows when the plan has
// one tile a job, else nb = 1).
struct Unit {
  long long b;
  int nb, t0, t1;
  __device__ long long row0(int seq) const { return b * seq + t0; }
  __device__ int rows() const { return nb * (t1 - t0); }
};

// A warp's walk over its jobs: its units are tiles 0 .. ntile - 1 of job
// slot, then of job slot + n_slots, ... A cursor (job, k) steps through
// them without divisions.
struct Walk {
  long long slot, n_slots, batch;
  int seq;
  Plan plan;

  __device__ int units() const {
    if (plan.n_jobs <= slot) return 0;
    return static_cast<int>((plan.n_jobs - 1 - slot) / n_slots + 1) *
           plan.ntile;
  }
  __device__ Unit at(long long job, int k) const {
    Unit x;
    if (plan.ntile == 1) {
      x.b = job * plan.rows_per_job;
      const long long left = batch - x.b;
      x.nb = left < plan.rows_per_job ? static_cast<int>(left)
                                      : plan.rows_per_job;
      x.t0 = 0;
      x.t1 = seq;
    } else {
      x.b = job;
      x.nb = 1;
      x.t0 = k * plan.tile;
      x.t1 = seq < x.t0 + plan.tile ? seq : x.t0 + plan.tile;
    }
    return x;
  }
  __device__ void next(long long& job, int& k) const {
    if (++k == plan.ntile) {
      k = 0;
      job += n_slots;
    }
  }
  // prefetch unit x's mask rows and the rows of `row_a` / `row_b` ([B, D],
  // row_b may be null) of its batch rows
  template <typename T>
  __device__ void prefetch(const Unit& x, const float* mask, const T* row_a,
                           const T* row_b, int dim, int lane) const {
    prefetch_l1(mask + x.row0(seq), x.rows() * 4ll, lane);
    const long long bytes = static_cast<long long>(x.nb) * dim * sizeof(T);
    prefetch_l1(row_a + x.b * dim, bytes, lane);
    if (row_b != nullptr) prefetch_l1(row_b + x.b * dim, bytes, lane);
  }
};

// The warp's ring over its units: stage u % kStages holds unit u once
// wait(u) returns; release(u) (all lanes, after the stage's last read)
// refills the stage with unit u + kStages. Lane 0 keeps the issue cursor.
template <typename T>
struct Ring {
  unsigned char* stages;
  uint64_t* bars;
  const T* src;
  int dim;
  int n_units;
  const Walk* walk;
  long long job;                    // the next unit to issue
  int k;

  __device__ void start(unsigned char* warp_base, const T* src_, int dim_,
                        const Walk* walk_, int lane) {
    stages = warp_base;
    bars = reinterpret_cast<uint64_t*>(warp_base + kStages * kStageBytes +
                                       kAttFloats * 4);
    src = src_;
    dim = dim_;
    walk = walk_;
    n_units = walk->units();
    job = walk->slot;
    k = 0;
    if (lane == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(bars + s);
      fence_mbar_init();
      for (int u = 0; u < kStages && u < n_units; ++u) issue(u);
    }
    __syncwarp();
  }
  __device__ void issue(int u) {
    const Unit x = walk->at(job, k);
    walk->next(job, k);
    const int s = u % kStages;
    bulk_load(stages + s * kStageBytes, src + x.row0(walk->seq) * dim,
              static_cast<uint32_t>(x.rows()) * dim * sizeof(T), bars + s);
  }
  __device__ const T* wait(int u) {
    const int s = u % kStages;
    mbar_wait(bars + s, static_cast<uint32_t>((u / kStages) & 1));
    return reinterpret_cast<const T*>(stages + s * kStageBytes);
  }
  __device__ void release(int u, int lane) {
    __syncwarp();
    if (lane == 0 && u + kStages < n_units) issue(u + kStages);
  }
};

}  // namespace din_pool
