// Backward of the cosine-gated DIN attention pool (K2b).
//
// Replaces: no Pallas kernel. The JAX trainer differentiates the pool
// inline (goctr_tpu/parallel/sparse_ctr.py:128-133, with the eps² norm
// clamp of goctr_tpu/ops/activations.py:63-67); its forward kernel is
// goctr_tpu/ops/pallas/din_attention.py::din_attention_pool_pallas
// (pallas_call at :97), ported as K2 (din_attention.cu). The port's
// trainer runs the pool through K2, so K2's gradient is this kernel.
//
// Forward, per batch row b (eps = 1e-8, e2 = eps²):
//   nb_t = sqrt(max(|b_t|², e2)), ni = sqrt(max(|i|², e2))
//   den_t = nb_t·ni + eps, cos_t = <b_t, i> / den_t
//   w_t = (cos_t + 1)/2, g_t = sigmoid(w_t·a_t), M = max(Σ_t m_t, 1)
//   out = Σ_t g_t·m_t·b_t / M
// Backward, given dout:
//   dgm_t  = <dout, b_t> / M
//   dz_t   = dgm_t·m_t·g_t·(1 − g_t)           d_att0_t += dz_t·w_t
//   dcos_t = dz_t·a_t/2, ddot_t = dcos_t/den_t, dden_t = −dcos_t·cos_t/den_t
//   d_b_t  = g_t·m_t/M·dout + ddot_t·i + [|b_t|² > e2]·dden_t·ni/nb_t·b_t
//   d_i    = Σ_t ddot_t·b_t + [|i|² > e2]·(Σ_t dden_t·nb_t)/ni·i
// A zero behavior row (|b|² = 0 < e2) takes no gradient through its
// norm, as the clamp's constant branch gives it in JAX: never a NaN.
// Inputs: dout [B, D] and behaviors [B, T, D], item [B, D] in f32 or
// bf16 (one dtype), att0 [T] and mask [B, T] f32. Outputs: d_behaviors,
// d_item in the input dtype, d_att0 [T] f32. All arithmetic is f32.
//
// What bounds it on the H100: bytes. It reads the behaviors once and
// writes d_behaviors once (B·T·D·2 bytes each in bf16: 268 MB each at the
// headline training batch B = 65,536, T = 32, D = 64), against ~16·D
// flops per (b, t) on the CUDA cores: ~0.17 ms at 3.35 TB/s.
// Design: as K2, one warp owns one batch row and loops over T; lane l
// holds dims l, l+32, ... in registers, item and dout stay in registers,
// d_item accumulates in registers, and the three per-step reductions
// (<b,i>, |b|², <dout,b>) are warp shuffles. d_att0 sums over all B rows:
// each block writes its rows' per-t contributions to shared memory, sums
// its 8 warps in a fixed order into one partial per (t, block), and a
// second kernel reduces each t's partials in a fixed order (a strided
// per-thread sum, then a shared-memory tree). No float atomics, so a run
// repeats bit for bit.
// Plain version: din_attention_pool_bwd_plain in
// goctr_tpu_torch/ops/kernels/din_attention.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxDim = 256;
constexpr int kReduceThreads = 256;

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

// partial[t * n_blocks + block] = Σ over the block's rows of dz_t·w_t.
template <typename T, int kPerLane>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
din_bwd_kernel(const T* __restrict__ dout, const T* __restrict__ beh,
               const T* __restrict__ item, const float* __restrict__ att0,
               const float* __restrict__ mask, T* __restrict__ d_beh,
               T* __restrict__ d_item, float* __restrict__ partial,
               long long batch, int seq, int dim) {
  extern __shared__ float s_att[];  // [kWarpsPerBlock][seq]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  const bool active = b < batch;  // uniform across the warp
  float* my_att = s_att + warp * seq;
  const float eps = 1e-8f;
  const float eps2 = eps * eps;

  if (active) {
    float it[kPerLane], go[kPerLane], di[kPerLane];
    float ii = 0.f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int d = lane + 32 * k;
      it[k] = d < dim ? to_f32(item[b * dim + d]) : 0.f;
      go[k] = d < dim ? to_f32(dout[b * dim + d]) : 0.f;
      di[k] = 0.f;
      ii += it[k] * it[k];
    }
    ii = warp_sum(ii);
    const float ni = sqrtf(fmaxf(ii, eps2));
    const float* mrow = mask + b * seq;
    float cnt = 0.f;
    for (int t = lane; t < seq; t += 32) cnt += mrow[t];
    const float den_m = fmaxf(warp_sum(cnt), 1.f);

    const T* rows = beh + b * seq * dim;
    T* drows = d_beh + b * seq * dim;
    float dni_sum = 0.f;
    for (int t = 0; t < seq; ++t) {
      float v[kPerLane];
      float dot = 0.f, bb = 0.f, gb = 0.f;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int d = lane + 32 * k;
        v[k] = d < dim ? to_f32(rows[static_cast<long long>(t) * dim + d]) : 0.f;
        dot += v[k] * it[k];
        bb += v[k] * v[k];
        gb += v[k] * go[k];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
        bb += __shfl_xor_sync(0xffffffffu, bb, o);
        gb += __shfl_xor_sync(0xffffffffu, gb, o);
      }
      const float m = mrow[t];
      const float a = att0[t];
      const float nb = sqrtf(fmaxf(bb, eps2));
      const float den = nb * ni + eps;
      const float cosv = dot / den;
      const float w = (cosv + 1.f) * 0.5f;
      const float g = 1.f / (1.f + expf(-(w * a)));
      const float gm = g * m;
      const float dgm = gb / den_m;
      const float dz = dgm * m * g * (1.f - g);
      const float dcos = dz * a * 0.5f;
      const float ddot = dcos / den;
      const float dden = -dcos * cosv / den;
      const float cb = bb > eps2 ? dden * ni / nb : 0.f;
      dni_sum += dden * nb;
      const float gmm = gm / den_m;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int d = lane + 32 * k;
        if (d < dim) {
          store(drows + static_cast<long long>(t) * dim + d,
                gmm * go[k] + ddot * it[k] + cb * v[k]);
        }
        di[k] += ddot * v[k];
      }
      if (lane == 0) my_att[t] = dz * w;
    }
    const float ci = ii > eps2 ? dni_sum / ni : 0.f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int d = lane + 32 * k;
      if (d < dim) store(d_item + b * dim + d, di[k] + ci * it[k]);
    }
  } else {
    for (int t = lane; t < seq; t += 32) my_att[t] = 0.f;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < seq; t += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) s += s_att[w * seq + t];
    partial[static_cast<long long>(t) * gridDim.x + blockIdx.x] = s;
  }
}

// d_att0[t] = Σ_j partial[t][j], one block per t, in a fixed order.
__global__ void __launch_bounds__(kReduceThreads)
att0_reduce_kernel(const float* __restrict__ partial, float* __restrict__ d_att0,
                   int n_parts) {
  __shared__ float s[kReduceThreads];
  const float* row = partial + static_cast<long long>(blockIdx.x) * n_parts;
  float acc = 0.f;
  for (int j = threadIdx.x; j < n_parts; j += kReduceThreads) acc += row[j];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int h = kReduceThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) s[threadIdx.x] += s[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) d_att0[blockIdx.x] = s[0];
}

template <typename T, int kPerLane>
cudaError_t launch_rows(dim3 grid, size_t smem, cudaStream_t s,
                        const T* go, const T* bp, const T* ip, const float* ap,
                        const float* mp, T* dbp, T* dip, float* part,
                        long long batch, int seq, int dim) {
  auto kernel = din_bwd_kernel<T, kPerLane>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kWarpsPerBlock * 32, smem, s>>>(go, bp, ip, ap, mp, dbp, dip,
                                                 part, batch, seq, dim);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* dout, const void* beh, const void* item,
           const void* att0, const void* mask, void* d_beh, void* d_item,
           void* d_att0, void* partial, long long batch, int seq, int dim,
           void* stream) {
  if (dim < 1 || dim > kMaxDim || seq < 1 || batch <= 0)
    return cudaErrorInvalidValue;
  const long long n_blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const dim3 grid(static_cast<unsigned>(n_blocks));
  const size_t smem = sizeof(float) * kWarpsPerBlock * seq;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* go = static_cast<const T*>(dout);
  const auto* bp = static_cast<const T*>(beh);
  const auto* ip = static_cast<const T*>(item);
  const auto* ap = static_cast<const float*>(att0);
  const auto* mp = static_cast<const float*>(mask);
  auto* dbp = static_cast<T*>(d_beh);
  auto* dip = static_cast<T*>(d_item);
  auto* part = static_cast<float*>(partial);
  cudaError_t e;
  if (dim <= 32) {
    e = launch_rows<T, 1>(grid, smem, s, go, bp, ip, ap, mp, dbp, dip, part, batch, seq, dim);
  } else if (dim <= 64) {
    e = launch_rows<T, 2>(grid, smem, s, go, bp, ip, ap, mp, dbp, dip, part, batch, seq, dim);
  } else if (dim <= 128) {
    e = launch_rows<T, 4>(grid, smem, s, go, bp, ip, ap, mp, dbp, dip, part, batch, seq, dim);
  } else {
    e = launch_rows<T, 8>(grid, smem, s, go, bp, ip, ap, mp, dbp, dip, part, batch, seq, dim);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  att0_reduce_kernel<<<seq, kReduceThreads, 0, s>>>(
      part, static_cast<float*>(d_att0), static_cast<int>(n_blocks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// partial: f32 scratch of seq * ceil(batch / 8) floats.
extern "C" int din_attention_bwd_f32(const void* dout, const void* beh,
                                     const void* item, const void* att0,
                                     const void* mask, void* d_beh,
                                     void* d_item, void* d_att0, void* partial,
                                     long long batch, int seq, int dim,
                                     void* stream) {
  return launch<float>(dout, beh, item, att0, mask, d_beh, d_item, d_att0,
                       partial, batch, seq, dim, stream);
}

extern "C" int din_attention_bwd_bf16(const void* dout, const void* beh,
                                      const void* item, const void* att0,
                                      const void* mask, void* d_beh,
                                      void* d_item, void* d_att0, void* partial,
                                      long long batch, int seq, int dim,
                                      void* stream) {
  return launch<__nv_bfloat16>(dout, beh, item, att0, mask, d_beh, d_item,
                               d_att0, partial, batch, seq, dim, stream);
}

extern "C" const char* din_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
