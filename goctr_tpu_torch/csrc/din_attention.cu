// Cosine-gated DIN attention pool (K2).
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
// Any B, T and D.
//
// What bounds it on the H100: bytes. The behaviors are read once
// (B·T·D·2 bytes in bf16: 268 MB at the training batch B = 65,536, T = 32,
// D = 64; 64 MB at serving's B = 16,384) against ~6·D flops per (b, t) on
// the CUDA cores.
// Design: the TPU kernel walks T as a sequential grid axis and carries
// an f32 accumulator in VMEM scratch across grid steps (:45-80). Here
// (din_pool.cuh) a persistent grid of warps streams its batch rows' [T, D]
// tiles through a ring of bulk copies into shared memory, so several KB a
// warp are in flight; a behavior row lies in a group of L lanes as
// 16-byte vectors, with the item row in the same lanes' registers. ⟨b,i⟩
// and |b|² come out of one pass over a lane's vectors and are summed over
// the group together (log2 L shuffle rounds), for U rows a group at once;
// every lane of the group computes the gate and adds gate·b_t into the
// group's accumulator in registers. Once a batch row, the warp sums the
// accumulators of the batch row's groups and divides by max(Σ mask, 1).
// Nothing crosses warps.
// Plain version: din_attention_pool_plain in
// goctr_tpu_torch/ops/kernels/din_attention.py.
#include "din_pool.cuh"

namespace {

using namespace din_pool;

// the fast path: lanes of a group hold KC 16-byte vectors of a row, and a
// group takes U rows a trip
template <typename T, int KC, int U>
__device__ void pool_ring(const T* __restrict__ beh, const T* __restrict__ item,
                          const float* __restrict__ att0,
                          const float* __restrict__ mask, T* __restrict__ out,
                          long long batch, int seq, int dim, const Plan& plan) {
  constexpr int V = Vec<T>::kN;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Walk walk{static_cast<long long>(blockIdx.x) * kWarps + warp,
                  static_cast<long long>(gridDim.x) * kWarps, batch, seq,
                  plan};
  const int L = plan.lanes;
  const int gl = lane & (L - 1);
  const int g = lane / L;
  const int G = 32 / L;
  // Q batch rows at once: set q (lanes q·S .. q·S + S - 1, S = 32 / Q)
  // takes batch row p0 + q with its Gq = G / Q groups
  const int Q = plan.rows_together;
  const int S = 32 / Q;
  const int Gq = G / Q;
  const int q = g / Gq;
  const int gq = g - q * Gq;
  const int nvec = plan.vec_per_row;
  const float e2 = kEps * kEps;
  Ring<T> ring;
  ring.start(smem + warp * kWarpSmem, beh, dim, &walk, lane);
  const int n_units = ring.n_units;

  float it[KC][V], acc[KC][V];
  float ni = 1.f, cnt = 0.f;
  long long job = walk.slot;      // the cursor: unit u is (job, k)
  int k_tile = 0;
  for (int u = 0; u < n_units; ++u) {
    const Unit x = walk.at(job, k_tile);
    walk.next(job, k_tile);
    if (u + 1 < n_units)
      walk.prefetch(walk.at(job, k_tile), mask, item,
                    static_cast<const T*>(nullptr), dim, lane);
    const T* stage = ring.wait(u);
    const int t0 = x.t0, t1 = x.t1;
    for (int p0 = 0; p0 < x.nb; p0 += Q) {  // Q segments, a batch row each
      const bool row_ok = p0 + q < x.nb;  // else this set idles
      const int p = row_ok ? p0 + q : p0;
      const long long b = x.b + p;
      if (t0 == 0) {              // the batch row begins
        float ii = 0.f;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const int v = gl + k * L;
          if (v < nvec) {
            Vec<T>::unpack(*reinterpret_cast<const uint4*>(
                               item + b * dim + v * V), it[k]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) it[k][e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < V; ++e) {
            acc[k][e] = 0.f;
            ii += it[k][e] * it[k][e];
          }
        }
        ni = sqrtf(fmaxf(group_sum(ii, L), e2));
        cnt = 0.f;
      }
      const T* seg = stage + static_cast<long long>(p) * (t1 - t0) * dim;
      const float* mrow = mask + b * seq;
      // U rows a group a trip (rows tt0 + u·Gq + gq), the same trips every
      // lane
      for (int tt0 = t0; tt0 < t1; tt0 += U * Gq) {
        // up to 4 rows stay in registers from the sums to the
        // accumulation; more are loaded again from shared memory
        constexpr bool kReload = U > 4;
        float keep[kReload ? 1 : U][KC][V];
        float dot[U], bb[U], m[U], a[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int tt = tt0 + u * Gq + gq;
          const bool valid = row_ok && tt < t1;
          m[u] = valid ? mrow[tt] : 0.f;
          a[u] = valid ? att0[tt] : 0.f;
          float (&bv)[KC][V] = keep[kReload ? 0 : u];
          load_row<T, KC>(seg, tt - t0, dim, gl, L, nvec, valid, bv);
          dot[u] = bb[u] = 0.f;
#pragma unroll
          for (int k = 0; k < KC; ++k)
#pragma unroll
            for (int e = 0; e < V; ++e) {
              dot[u] += bv[k][e] * it[k][e];
              bb[u] += bv[k][e] * bv[k][e];
            }
        }
        for (int o = L >> 1; o > 0; o >>= 1) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], o);
            bb[u] += __shfl_xor_sync(0xffffffffu, bb[u], o);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int tt = tt0 + u * Gq + gq;
          const bool valid = row_ok && tt < t1;
          const float bbc = fmaxf(bb[u], e2);
          const float cosv = dot[u] * rcp_(bbc * rsqrtf(bbc) * ni + kEps);
          const float w = (cosv + 1.f) * 0.5f;
          const float gate = m[u] * rcp_(1.f + __expf(-(w * a[u])));
          float (&bv)[KC][V] = keep[kReload ? 0 : u];
          if (kReload)
            load_row<T, KC>(seg, tt - t0, dim, gl, L, nvec, valid, bv);
#pragma unroll
          for (int k = 0; k < KC; ++k)
#pragma unroll
            for (int e = 0; e < V; ++e) acc[k][e] += gate * bv[k][e];
          cnt += m[u];
        }
      }
      if (t1 == seq) {            // the batch row ends
        // every lane of a group holds the group's count: sum the set's
        // groups
        const float rden = rcp_(fmaxf(across_groups(cnt, L, S), 1.f));
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          float o[V];
#pragma unroll
          for (int e = 0; e < V; ++e)
            o[e] = across_groups(acc[k][e], L, S) * rden;
          const int v = gl + k * L;
          if (row_ok && gq == 0 && v < nvec)
            *reinterpret_cast<uint4*>(out + b * dim + v * V) =
                Vec<T>::pack(o);
        }
      }
    }
    ring.release(u, lane);
  }
}

// the generic path: one warp a batch row, element loads, outputs in
// chunks of kGenericChunk with the row sums recomputed for each chunk
template <typename T>
__device__ void pool_generic(const T* __restrict__ beh,
                             const T* __restrict__ item,
                             const float* __restrict__ att0,
                             const float* __restrict__ mask,
                             T* __restrict__ out, long long batch, int seq,
                             int dim) {
  constexpr int E = kGenericPerLane;
  const int lane = threadIdx.x & 31;
  const long long n_slots = static_cast<long long>(gridDim.x) * kWarps;
  const float e2 = kEps * kEps;
  for (long long b = static_cast<long long>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5);
       b < batch; b += n_slots) {
    const T* irow = item + b * dim;
    float ii = 0.f, cnt = 0.f;
    for (int d = lane; d < dim; d += 32) {
      const float x = to_f32(irow[d]);
      ii += x * x;
    }
    for (int t = lane; t < seq; t += 32) cnt += mask[b * seq + t];
    const float ni = sqrtf(fmaxf(group_sum(ii, 32), e2));
    const float den = fmaxf(group_sum(cnt, 32), 1.f);
    for (int c0 = 0; c0 < dim; c0 += kGenericChunk) {
      float acc[E];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.f;
      for (int t = 0; t < seq; ++t) {
        const T* row = beh + (b * seq + t) * dim;
        float dot = 0.f, bb = 0.f;
        for (int d = lane; d < dim; d += 32) {
          const float x = to_f32(row[d]);
          dot += x * to_f32(irow[d]);
          bb += x * x;
        }
        for (int o = 16; o > 0; o >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
          bb += __shfl_xor_sync(0xffffffffu, bb, o);
        }
        const float cosv = dot / (sqrtf(fmaxf(bb, e2)) * ni + kEps);
        const float w = (cosv + 1.f) * 0.5f;
        const float gate = mask[b * seq + t] / (1.f + expf(-(w * att0[t])));
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = c0 + lane + 32 * e;
          if (d < dim) acc[e] += gate * to_f32(row[d]);
        }
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = c0 + lane + 32 * e;
        if (d < dim) store(out + b * dim + d, acc[e] / den);
      }
    }
  }
}

template <typename T, int KC, int U>
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSM)
din_pool_kernel(const T* __restrict__ beh, const T* __restrict__ item,
                const float* __restrict__ att0,
                const float* __restrict__ mask, T* __restrict__ out,
                long long batch, int seq, int dim, Plan plan) {
  if constexpr (KC == 0) {
    pool_generic<T>(beh, item, att0, mask, out, batch, seq, dim);
  } else {
    pool_ring<T, KC, U>(beh, item, att0, mask, out, batch, seq, dim, plan);
  }
}

template <typename T, int KC, int U>
cudaError_t run(Plan& p, int n_sms, cudaStream_t s, const T* bp, const T* ip,
                const float* ap, const float* mp, T* op, long long batch,
                int seq, int dim) {
  auto kernel = din_pool_kernel<T, KC, U>;
  const cudaError_t e = fit(kernel, p, n_sms);
  if (e != cudaSuccess) return e;
  kernel<<<p.grid, kWarps * 32, p.smem, s>>>(bp, ip, ap, mp, op, batch, seq,
                                              dim, p);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* beh, const void* item, const void* att0,
           const void* mask, void* out, long long batch, int seq, int dim,
           void* stream, int n_sms) {
  if (dim < 1 || seq < 0 || n_sms < 1) return cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* bp = static_cast<const T*>(beh);
  const auto* ip = static_cast<const T*>(item);
  const auto* ap = static_cast<const float*>(att0);
  const auto* mp = static_cast<const float*>(mask);
  auto* op = static_cast<T*>(out);
  if (seq == 0) {                 // nothing to pool: zeros
    return static_cast<int>(
        cudaMemsetAsync(out, 0, batch * dim * sizeof(T), s));
  }
  const bool fast = aligned16(beh) && aligned16(item) && aligned16(out);
  Plan p = make_plan(batch, seq, dim, sizeof(T), fast, n_sms);
  cudaError_t e;
  if (p.kc == 1 && p.rows_at_once == 8) {
    e = run<T, 1, 8>(p, n_sms, s, bp, ip, ap, mp, op, batch, seq, dim);
  } else if (p.kc == 1 && p.rows_at_once == 4) {
    e = run<T, 1, 4>(p, n_sms, s, bp, ip, ap, mp, op, batch, seq, dim);
  } else if (p.kc == 1 && p.rows_at_once == 2) {
    e = run<T, 1, 2>(p, n_sms, s, bp, ip, ap, mp, op, batch, seq, dim);
  } else if (p.kc == 1) {
    e = run<T, 1, 1>(p, n_sms, s, bp, ip, ap, mp, op, batch, seq, dim);
  } else if (p.kc == 2 && p.rows_at_once == 2) {
    e = run<T, 2, 2>(p, n_sms, s, bp, ip, ap, mp, op, batch, seq, dim);
  } else if (p.kc == 2) {
    e = run<T, 2, 1>(p, n_sms, s, bp, ip, ap, mp, op, batch, seq, dim);
  } else {
    e = run<T, 0, 1>(p, n_sms, s, bp, ip, ap, mp, op, batch, seq, dim);
  }
  return static_cast<int>(e);
}

}  // namespace

// n_sms: the card's SM count (the persistent grid's size).
extern "C" int din_attention_f32(const void* beh, const void* item,
                                 const void* att0, const void* mask, void* out,
                                 long long batch, int seq, int dim,
                                 void* stream, int n_sms) {
  return launch<float>(beh, item, att0, mask, out, batch, seq, dim, stream,
                       n_sms);
}

extern "C" int din_attention_bf16(const void* beh, const void* item,
                                  const void* att0, const void* mask, void* out,
                                  long long batch, int seq, int dim,
                                  void* stream, int n_sms) {
  return launch<__nv_bfloat16>(beh, item, att0, mask, out, batch, seq, dim,
                               stream, n_sms);
}

extern "C" const char* din_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
