// Row gather by id over the three table layouts of the serving path.
//
// Replaces: goctr_tpu/ops/pallas/row_gather.py::_kernel /
// gather_rows_packed (pallas_call at :74), and the `jnp.take` + lane
// slice + one-hot select + `.astype(cd)` of `rows_of`
// (goctr_tpu/serve/scorer.py:88-99, goctr_tpu/parallel/scanned.py:92-100).
//
// One kernel serves the three layouts through (stride, group, dim):
//   plain   [V, D]        group 1, stride D
//   packed  [V, 128]      group 1, stride 128, first D lanes
//   grouped [L, 128]      group G = 128 / (D+1): line id / G,
//                         lanes (id % G)·(D+1) … +D
// The output is written in the compute dtype (f32 or bf16, round to
// nearest even), so the cast is folded into the copy. An id outside
// [0, n_rows) is never read: its output row is NaN, which is what
// `jnp.take` returns for it in the JAX package.
//
// What bounds it on the H100: bytes. Each output row reads D·4 bytes of
// table (256 B at D = 64) from a random place in a multi-GB table and
// writes D·2 or D·4 bytes; there is no arithmetic. At the headline
// (17,408 rows, bf16 out) that is ~6.7 MB, ~2 us at 3.35 TB/s.
// Design: one warp per output row, so the reads of a row are one
// contiguous burst; the ids are read by the block itself (the TPU
// kernel's scalar prefetch has no counterpart to port); where the row
// start and width allow (group 1, D and stride multiples of 4, aligned
// pointers) each lane moves 16 bytes with one float4 load; grouped rows
// start at (id % G)·(D+1) floats, which is not 16-byte aligned, and take
// the scalar path. Many warps in flight stand in for the TPU kernel's
// ring of outstanding row DMAs.
// Plain version: gather_rows_plain in
// goctr_tpu_torch/ops/kernels/row_gather.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename Out, bool kVec4>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
row_gather_kernel(const float* __restrict__ table,
                  const int* __restrict__ ids, Out* __restrict__ out,
                  long long n, long long n_rows, long long stride,
                  int group, int dim) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= n) return;
  const int lane = threadIdx.x & 31;
  const int id = __ldg(ids + row);
  Out* dst = out + row * dim;
  if (id < 0 || id >= n_rows) {
    const float nan = __int_as_float(0x7fc00000);
    for (int d = lane; d < dim; d += 32) store1(dst + d, nan);
    return;
  }
  const float* src = table + static_cast<long long>(id / group) * stride +
                     static_cast<long long>(id % group) * (dim + 1);
  if (kVec4) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int c = lane; c < dim / 4; c += 32) store4(dst + 4 * c, __ldg(src4 + c));
  } else {
    for (int d = lane; d < dim; d += 32) store1(dst + d, __ldg(src + d));
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename Out>
int launch(const void* table, const void* ids, void* out, long long n,
           long long n_rows, long long stride, int group, int dim,
           void* stream) {
  if (n <= 0) return 0;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const bool vec4 = group == 1 && dim % 4 == 0 && stride % 4 == 0 &&
                    aligned(table, 16) && aligned(out, 4 * sizeof(Out));
  const auto* t = static_cast<const float*>(table);
  const auto* i = static_cast<const int*>(ids);
  auto* o = static_cast<Out*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    row_gather_kernel<Out, true><<<grid, block, 0, s>>>(t, i, o, n, n_rows, stride, group, dim);
  } else {
    row_gather_kernel<Out, false><<<grid, block, 0, s>>>(t, i, o, n, n_rows, stride, group, dim);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int row_gather_f32(const void* table, const void* ids, void* out,
                              long long n, long long n_rows, long long stride,
                              int group, int dim, void* stream) {
  return launch<float>(table, ids, out, n, n_rows, stride, group, dim, stream);
}

extern "C" int row_gather_bf16(const void* table, const void* ids, void* out,
                               long long n, long long n_rows, long long stride,
                               int group, int dim, void* stream) {
  return launch<__nv_bfloat16>(table, ids, out, n, n_rows, stride, group, dim,
                               stream);
}

extern "C" const char* row_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
