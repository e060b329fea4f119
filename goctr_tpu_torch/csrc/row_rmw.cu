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
// here each thread takes the accumulator from the thread that holds it
// with __shfl_sync.
//
// ids of real rows are pairwise distinct (the trainer sums duplicates
// before), so no two warps touch one line and no atomics are needed. An
// id >= skip_ge (junk targets L+n+1+k, which point past the table) or < 0
// is skipped before any address is formed; the caller keeps skip_ge <=
// the table's rows. Line offsets are 64-bit: the 100M × 16 lines are
// 7.3 GB.
//
// What bounds it on the H100: bytes. Each real row reads the 32-byte
// sectors of its line and of its update row that hold the G·(d+1) live
// lanes and writes the line's back; a skipped row costs its 4-byte id.
// At the 100M × 16 training step (~577k real lines of 769,024 slots, 480
// of 512 bytes live) that is ~0.83 GB, ~0.25 ms at 3.35 TB/s; at the
// 10M × 64 step (~519k real rows, 288 of 512 bytes live) ~0.45 GB,
// ~0.135 ms. The arithmetic (a few flops a lane) is negligible.
// Design: one warp per update row, thread l holding lanes 4l … 4l+3 of
// the line as one float4, so each line is one coalesced load and one
// store; threads whose four lanes all lie past G·(d+1) (15 of 32 at
// d = 64) skip both. A warp takes kRowsPerWarp rows and issues all their loads
// before it computes any, so several rows' loads are in flight per warp
// (the TPU kernel's ring of 8 outstanding DMA pairs; K2, with one load in
// flight per warp, ran at 3.6x its bound).
// Plain version: apply_row_updates_plain / apply_line_updates_plain in
// goctr_tpu_torch/ops/kernels/row_optimizer.py (index_select, the same
// f32 terms in torch, index_put_).
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kLanes = 128;  // floats per line: 32 lanes x float4
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <bool kAdagrad>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rmw_kernel(float* __restrict__ table, const int* __restrict__ ids,
           const float* __restrict__ upd, long long n, long long skip_ge,
           int d, int group, float lr, float eps) {
  const int lane = threadIdx.x & 31;
  const long long first =
      (static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32) *
      kRowsPerWarp;
  // this thread's four lanes: their masks, and where each weight lane's
  // group accumulator lives (thread src, component cmp). A thread with no
  // live lane loads and stores nothing; it still joins the shuffles, and
  // no live lane's accumulator lies in it.
  const int stride = d + 1;
  const bool live = 4 * lane < group * stride;
  bool is_w[4];
  float m_acc[4];
  int src[4], cmp[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = 4 * lane + k;
    const bool within = c < group * stride;
    const int r = c % stride;
    is_w[k] = within && r < d;
    m_acc[k] = (within && r == d) ? 1.0f : 0.0f;
    const int a = is_w[k] ? c - r + d : c;
    src[k] = a >> 2;
    cmp[k] = a & 3;
  }
  int id[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const long long j = first + i;
    id[i] = j < n ? __ldg(ids + j) : -1;
    if (id[i] >= skip_ge) id[i] = -1;  // uniform across the warp
  }
  // every load of the warp's rows before any compute
  float4 t[kRowsPerWarp], u[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    t[i] = u[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (id[i] < 0 || !live) continue;
    t[i] = reinterpret_cast<const float4*>(
        table + static_cast<long long>(id[i]) * kLanes)[lane];
    u[i] = __ldg(reinterpret_cast<const float4*>(upd + (first + i) * kLanes) +
                 lane);
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (id[i] < 0) continue;
    float out[4];
    if (kAdagrad) {
      float ra[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        ra[k] = __fadd_rn(comp(t[i], k), __fmul_rn(comp(u[i], k), m_acc[k]));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float x0 = __shfl_sync(kFull, ra[0], src[k]);
        const float x1 = __shfl_sync(kFull, ra[1], src[k]);
        const float x2 = __shfl_sync(kFull, ra[2], src[k]);
        const float x3 = __shfl_sync(kFull, ra[3], src[k]);
        const float acc =
            cmp[k] == 0 ? x0 : cmp[k] == 1 ? x1 : cmp[k] == 2 ? x2 : x3;
        // on a weight lane the JAX kernels' products by m_w = 1 are exact
        const float scale = __fmul_rn(lr, rsqrtf(__fadd_rn(acc, eps)));
        out[k] = is_w[k]
                     ? __fsub_rn(ra[k], __fmul_rn(scale, comp(u[i], k)))
                     : ra[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        out[k] = is_w[k]
                     ? __fsub_rn(comp(t[i], k), __fmul_rn(lr, comp(u[i], k)))
                     : comp(t[i], k);
    }
    if (live)
      reinterpret_cast<float4*>(
          table + static_cast<long long>(id[i]) * kLanes)[lane] =
          make_float4(out[0], out[1], out[2], out[3]);
  }
}

int launch(void* table, const void* ids, const void* upd, long long n,
           long long skip_ge, int d, bool grouped, int adagrad, float lr,
           float eps, void* stream) {
  if (d <= 0 || d >= kLanes) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int group = grouped ? kLanes / (d + 1) : 1;
  constexpr long long kRowsPerBlock = kWarpsPerBlock * kRowsPerWarp;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>((n + kRowsPerBlock - 1) / kRowsPerBlock));
  auto* t = static_cast<float*>(table);
  const auto* i = static_cast<const int*>(ids);
  const auto* u = static_cast<const float*>(upd);
  auto s = static_cast<cudaStream_t>(stream);
  if (adagrad) {
    rmw_kernel<true><<<grid, block, 0, s>>>(t, i, u, n, skip_ge, d, group, lr, eps);
  } else {
    rmw_kernel<false><<<grid, block, 0, s>>>(t, i, u, n, skip_ge, d, group, lr, eps);
  }
  return static_cast<int>(cudaGetLastError());
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
