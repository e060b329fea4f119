// Fused gather + sum/mean pool over the K ids of each batch row.
//
// Replaces: goctr_tpu/ops/pallas/embedding_lookup.py::_kernel /
// fused_gather_pool_pallas (pallas_call at :106), the forward of the
// custom VJP gather_pool_mean (:146-178), and fused_gather_pool_jnp
// (:114-122), the path JAX takes at the trainer's shapes (D = 64 fails
// the TPU kernel's D % 128 gate).
//
//   out[b] = sum_k [ids[b,k] >= 0] * table[ids[b,k]]        (sum)
//   out[b] = that / max(#{k : ids[b,k] >= 0}, 1)            (mean)
//
// table [V, D] f32, ids [B, K] int32 (-1 = pad), out [B, D] f32. Pads add
// nothing and a fully padded row gives 0; an id >= V is never read and adds
// a NaN row (what `jnp.take` returns for it, and what K1 returns), but it
// counts as valid, as in the JAX function. The TPU kernel's three gates
// (D % 128 == 0, B % 8 == 0, K >= 8) are Mosaic tiling limits, not
// semantics: this kernel takes any B, any K and 1 <= D <= 256.
//
// What bounds it on the H100: bytes. Each batch row reads K ids and up to
// K table rows (D * 4 bytes each, 256 B at D = 64) from random places of a
// multi-GB table, and writes D * 4 bytes; the adds are ~K * D flops, far
// under the card's rate. At the dense trainer's shape (B = 65,536, K = 32,
// D = 64) that is 8.4 MB of ids, 16.8 MB of output and, since the zipf ids
// repeat, ~0.5M distinct rows (~130 MB) if each were read once: ~0.05 ms at
// 3.35 TB/s. Reading every occurrence from HBM would take ~0.16 ms; hot rows
// repeat enough that L2 serves much of that.
// Design: one warp per batch row. The row's ids are read once by the warp
// (lane j holds id j of each chunk of 32), broadcast by shuffle, and the
// valid count is a popcount of a ballot. The lanes are cut into S = 32 /
// lpr slots of lpr lanes; a slot covers one table row with 16-byte float4
// loads (float2 or scalar where D or the pointers do not allow it), so at
// D = 64 a warp reads two rows at once, at D = 16 eight. The K loop is
// unrolled kUnroll times, so each warp has kUnroll * S rows' loads in flight
// before it adds any (8 rows at D = 64): one load in flight per warp left
// K2 and K2b at 3.6x and 3.0x their bound. The S partial sums are combined
// by xor shuffles; the first slot divides (IEEE division, as JAX's `/`) and
// writes. The [B, K, D] rows never leave registers. The TPU kernel's
// double-buffered row DMAs have no counterpart to port: many warps in
// flight hide the latency instead.
// Plain version: fused_gather_pool_plain in
// goctr_tpu_torch/ops/kernels/embedding_lookup.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDim = 256;

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]);
template <>
__device__ __forceinline__ void load<1>(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}
template <>
__device__ __forceinline__ void load<2>(const float* p, float (&v)[2]) {
  const float2 t = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = t.x;
  v[1] = t.y;
}
template <>
__device__ __forceinline__ void load<4>(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]);
template <>
__device__ __forceinline__ void store<1>(float* p, const float (&v)[1]) {
  *p = v[0];
}
template <>
__device__ __forceinline__ void store<2>(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
template <>
__device__ __forceinline__ void store<4>(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// VEC floats a load, CH loads a lane per table row (lpr lanes cover a row:
// CH * lpr * VEC >= D), MEAN divides by the valid count.
template <int VEC, int CH, bool MEAN>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_pool_kernel(const float* __restrict__ table,
                   const int* __restrict__ ids, float* __restrict__ out,
                   long long batch, int k, long long n_rows, int dim,
                   int lpr) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= batch) return;  // the whole warp: row is the warp's
  const int lane = threadIdx.x & 31;
  const int slot = lane / lpr;
  const int col = lane % lpr;
  const int slots = 32 / lpr;
  const float nan = __int_as_float(0x7fc00000);
  float acc[CH][VEC];
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[c][e] = 0.f;
  int count = 0;
  const int* row_ids = ids + row * k;
  for (int k0 = 0; k0 < k; k0 += 32) {
    const int n = min(32, k - k0);
    const int my_id = lane < n ? __ldg(row_ids + k0 + lane) : -1;
    count += __popc(__ballot_sync(kFull, my_id >= 0));
    // every lane runs the same trip count, so the shuffles stay converged
    for (int j0 = 0; j0 < n; j0 += slots * kUnroll) {
      float v[kUnroll][CH][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * slots + slot;
        const int id = __shfl_sync(kFull, my_id, j & 31);
        const bool live = j < n && id >= 0;
        const float* src = table + static_cast<long long>(id) * dim;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int d0 = (col + c * lpr) * VEC;
          if (live && d0 < dim && id < n_rows) {
            load<VEC>(src + d0, v[u][c]);
          } else {
            const float fill = live ? nan : 0.f;  // id >= V: a NaN row
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[u][c][e] = fill;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int c = 0; c < CH; ++c)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[c][e] += v[u][c][e];
    }
  }
  // combine the slots: lanes lpr apart hold the same columns
  for (int off = lpr; off < 32; off <<= 1)
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[c][e] += __shfl_xor_sync(kFull, acc[c][e], off);
  if (slot != 0) return;
  const float denom = fmaxf(static_cast<float>(count), 1.f);
  float* dst = out + row * dim;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int d0 = (col + c * lpr) * VEC;
    if (d0 >= dim) continue;
    float r[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) r[e] = MEAN ? acc[c][e] / denom : acc[c][e];
    store<VEC>(dst + d0, r);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int VEC, int CH>
void launch_vc(const float* t, const int* i, float* o, long long batch,
               int k, long long n_rows, int dim, int lpr, bool mean,
               cudaStream_t s) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>(
      (batch + kWarpsPerBlock - 1) / kWarpsPerBlock));
  if (mean) {
    gather_pool_kernel<VEC, CH, true><<<grid, block, 0, s>>>(
        t, i, o, batch, k, n_rows, dim, lpr);
  } else {
    gather_pool_kernel<VEC, CH, false><<<grid, block, 0, s>>>(
        t, i, o, batch, k, n_rows, dim, lpr);
  }
}

template <int VEC>
void launch_v(const float* t, const int* i, float* o, long long batch,
              int k, long long n_rows, int dim, bool mean, cudaStream_t s) {
  const int nvec = dim / VEC;
  int lpr = 1;
  while (lpr < nvec && lpr < 32) lpr <<= 1;
  // loads a lane per row: 1, 2, 4 or 8, at most kMaxDim / (32 * VEC)
  int ch = 1;
  while (ch * lpr < nvec) ch <<= 1;
  if (ch == 1) {
    launch_vc<VEC, 1>(t, i, o, batch, k, n_rows, dim, lpr, mean, s);
  } else if (ch == 2) {
    launch_vc<VEC, 2>(t, i, o, batch, k, n_rows, dim, lpr, mean, s);
  } else if constexpr (VEC <= 2) {
    if (ch == 4) {
      launch_vc<VEC, 4>(t, i, o, batch, k, n_rows, dim, lpr, mean, s);
    } else if constexpr (VEC == 1) {
      launch_vc<VEC, 8>(t, i, o, batch, k, n_rows, dim, lpr, mean, s);
    }
  }
}

}  // namespace

// table [n_rows, dim] f32, ids [batch, k] int32, out [batch, dim] f32;
// mean != 0 divides by the valid count. Returns cudaGetLastError().
extern "C" int gather_pool_f32(const void* table, const void* ids, void* out,
                               long long batch, int k, long long n_rows,
                               int dim, int mean, void* stream) {
  if (dim < 1 || dim > kMaxDim || k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0) return 0;
  const auto* t = static_cast<const float*>(table);
  const auto* i = static_cast<const int*>(ids);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (dim % 4 == 0 && aligned(table, 16) && aligned(out, 16)) {
    launch_v<4>(t, i, o, batch, k, n_rows, dim, mean != 0, s);
  } else if (dim % 2 == 0 && aligned(table, 8) && aligned(out, 8)) {
    launch_v<2>(t, i, o, batch, k, n_rows, dim, mean != 0, s);
  } else {
    launch_v<1>(t, i, o, batch, k, n_rows, dim, mean != 0, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gather_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
