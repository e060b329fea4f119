// Cosine-gated DIN attention pool.
//
// Replaces: goctr_tpu/ops/pallas/din_attention.py::_kernel /
// din_attention_pool_pallas (pallas_call at :97), whose math the serving
// path computes inline in SparseCTR.apply_pooled
// (goctr_tpu/parallel/sparse_ctr.py:128-133):
//   cos_t = <b_t, i> / (max(|b_t|, eps) · max(|i|, eps) + eps)
//   gate  = sigmoid((cos_t + 1) / 2 · att0_t) · mask_t
//   out   = Σ_t gate_t · b_t / max(Σ_t mask_t, 1)
// behaviors [B, T, D] and item [B, D] in f32 or bf16, att0 [T] and
// mask [B, T] in f32; out [B, D] in the behaviors' dtype. All arithmetic
// is f32. The norms are clamped at eps² before the sqrt, as
// cosine_similarity does (goctr_tpu/ops/activations.py:63-67); for any
// row with a nonzero norm this is the Pallas kernel's dot/(|b||i|+1e-8).
//
// What bounds it on the H100: bytes. The behaviors are read once
// (B·T·D·2 bytes in bf16: 64 MB at the headline B = 16,384, T = 32,
// D = 64) against ~6·D flops per (b, t) on the CUDA cores; the bound is
// ~21 us at 3.35 TB/s.
// Design: the TPU kernel walks T as a sequential grid axis and carries
// an f32 accumulator in VMEM scratch across grid steps (:45-80). Blocks
// on Hopper run in no order, so here one warp owns one batch row and
// loops over all of T itself: the accumulator lives in registers (D/32
// floats a lane), each behavior element is loaded once, coalesced (lane
// l holds dims l, l+32, ...), and the two per-step reductions (dot,
// |b|²) are warp shuffles. Nothing crosses blocks, and the loop is
// bounded at T, so a ragged T needs no tail masking.
// Plain version: din_attention_pool_plain in
// goctr_tpu_torch/ops/kernels/din_attention.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxDim = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kPerLane = ceil(D / 32) values of a row held by each lane.
template <typename T, int kPerLane>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
din_pool_kernel(const T* __restrict__ beh, const T* __restrict__ item,
                const float* __restrict__ att0,
                const float* __restrict__ mask, T* __restrict__ out,
                long long batch, int seq, int dim) {
  const long long b =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (b >= batch) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const float eps = 1e-8f;
  const float eps2 = eps * eps;

  float it[kPerLane], acc[kPerLane];
  float ii = 0.f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int d = lane + 32 * k;
    it[k] = d < dim ? to_f32(item[b * dim + d]) : 0.f;
    acc[k] = 0.f;
    ii += it[k] * it[k];
  }
  const float inorm = sqrtf(fmaxf(warp_sum(ii), eps2));

  const T* rows = beh + b * seq * dim;
  const float* mrow = mask + b * seq;
  float cnt = 0.f;
  for (int t = 0; t < seq; ++t) {
    float v[kPerLane];
    float dot = 0.f, bb = 0.f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int d = lane + 32 * k;
      v[k] = d < dim ? to_f32(rows[static_cast<long long>(t) * dim + d]) : 0.f;
      dot += v[k] * it[k];
      bb += v[k] * v[k];
    }
    dot = warp_sum(dot);
    bb = warp_sum(bb);
    const float m = mrow[t];
    const float cosv = dot / (sqrtf(fmaxf(bb, eps2)) * inorm + eps);
    const float w = (cosv + 1.f) * 0.5f;
    const float gate = m / (1.f + expf(-(w * att0[t])));
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) acc[k] += gate * v[k];
    cnt += m;
  }
  const float den = fmaxf(cnt, 1.f);
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int d = lane + 32 * k;
    if (d < dim) store(out + b * dim + d, acc[k] / den);
  }
}

template <typename T>
int launch(const void* beh, const void* item, const void* att0,
           const void* mask, void* out, long long batch, int seq, int dim,
           void* stream) {
  if (dim < 1 || dim > kMaxDim || seq < 0) return cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>((batch + kWarpsPerBlock - 1) / kWarpsPerBlock));
  auto s = static_cast<cudaStream_t>(stream);
  const auto* bp = static_cast<const T*>(beh);
  const auto* ip = static_cast<const T*>(item);
  const auto* ap = static_cast<const float*>(att0);
  const auto* mp = static_cast<const float*>(mask);
  auto* op = static_cast<T*>(out);
  if (dim <= 32) {
    din_pool_kernel<T, 1><<<grid, block, 0, s>>>(bp, ip, ap, mp, op, batch, seq, dim);
  } else if (dim <= 64) {
    din_pool_kernel<T, 2><<<grid, block, 0, s>>>(bp, ip, ap, mp, op, batch, seq, dim);
  } else if (dim <= 128) {
    din_pool_kernel<T, 4><<<grid, block, 0, s>>>(bp, ip, ap, mp, op, batch, seq, dim);
  } else {
    din_pool_kernel<T, 8><<<grid, block, 0, s>>>(bp, ip, ap, mp, op, batch, seq, dim);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int din_attention_f32(const void* beh, const void* item,
                                 const void* att0, const void* mask, void* out,
                                 long long batch, int seq, int dim,
                                 void* stream) {
  return launch<float>(beh, item, att0, mask, out, batch, seq, dim, stream);
}

extern "C" int din_attention_bf16(const void* beh, const void* item,
                                  const void* att0, const void* mask, void* out,
                                  long long batch, int seq, int dim,
                                  void* stream) {
  return launch<__nv_bfloat16>(beh, item, att0, mask, out, batch, seq, dim,
                               stream);
}

extern "C" const char* din_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
