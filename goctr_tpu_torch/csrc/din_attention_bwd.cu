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
// d_item in the input dtype, d_att0 [T] f32. Arithmetic is f32 for bf16
// inputs and f64 for f32 inputs (Acc in din_pool.cuh, as the plain
// version). Any B, T and D.
//
// What bounds it on the H100: bytes. It reads the behaviors once and
// writes d_behaviors once (B·T·D·2 bytes each in bf16: 268 MB each at the
// headline training batch B = 65,536, T = 32, D = 64), against ~16·D
// flops per (b, t) on the CUDA cores: ~0.17 ms at 3.35 TB/s.
// Design: (the shared parts are in din_pool.cuh) a persistent grid of
// warps, each streaming its batch rows' [T, D] tiles through a ring of
// bulk copies into shared memory; a behavior row lies in a group of L
// lanes as 16-byte vectors, with the item and dout rows in the same lanes'
// registers. ⟨b,i⟩, |b|² and ⟨dout,b⟩ come out of one pass over a lane's
// vectors and are summed over the group together (log2 L shuffle rounds:
// 3 at D = 64 bf16, 1 at D = 16), for U rows a group at once; every lane
// of the group then computes the per-t scalars (row_grad) and writes its
// part of d_b_t with 16-byte stores. d_item accumulates per group and is
// summed over the groups of its batch row once a batch row.
// d_att0, with no float atomics, in a fixed order: each warp sums its
// rows' dz_t·w_t per t in shared memory (its rows in its fixed order; the
// sets of a warp that takes Q batch rows at once add one after another),
// and writes them to a partial [t][warp slot] (after each T-tile when T is
// cut into tiles); a second kernel sums each t's partials in a fixed
// order. A call repeats bit for bit.
// Plain version: din_attention_pool_bwd_plain in
// goctr_tpu_torch/ops/kernels/din_attention.py.
#include "din_pool.cuh"

namespace {

using namespace din_pool;

constexpr int kReduceThreads = 256;

// the fast path: lanes of a group hold KC 16-byte vectors of a row, and a
// group takes U rows a trip
template <typename T, int KC, int U>
__device__ void bwd_ring(const T* __restrict__ dout, const T* __restrict__ beh,
                         const T* __restrict__ item,
                         const float* __restrict__ att0,
                         const float* __restrict__ mask, T* __restrict__ d_beh,
                         T* __restrict__ d_item, float* __restrict__ partial,
                         long long batch, int seq, int dim, const Plan& plan) {
  constexpr int V = Vec<T>::kN;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Walk walk{static_cast<long long>(blockIdx.x) * kWarps + warp,
                  static_cast<long long>(gridDim.x) * kWarps, batch, seq,
                  plan};
  unsigned char* wbase = smem + warp * kWarpSmem;
  float* s_att = reinterpret_cast<float*>(wbase + kStages * kStageBytes);
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
  for (int i = lane; i < kAttFloats; i += 32) s_att[i] = 0.f;
  Ring<T> ring;
  ring.start(wbase, beh, dim, &walk, lane);
  const int n_units = ring.n_units;
  const long long slot = walk.slot, n_slots = walk.n_slots;
  if (n_units == 0) {
    for (int t = lane; t < seq; t += 32) partial[t * n_slots + slot] = 0.f;
    return;
  }

  using A = typename Acc<T>::type;
  float it[KC][V], go[KC][V];
  A di[KC][V];
  A ii = 0, dni = 0, ni = 1, rden_m = 1;
  long long job = slot;           // the cursor: unit u is (job, k)
  int k_tile = 0;
  for (int u = 0; u < n_units; ++u) {
    const Unit x = walk.at(job, k_tile);
    walk.next(job, k_tile);
    if (u + 1 < n_units)
      walk.prefetch(walk.at(job, k_tile), mask, item, dout, dim, lane);
    const T* stage = ring.wait(u);
    const int t0 = x.t0, t1 = x.t1;
    // d_att0 sums of t at s_att[t - tbase]: all of T, or this T-tile
    const int tbase = plan.ntile > 1 ? t0 : 0;
    for (int p0 = 0; p0 < x.nb; p0 += Q) {  // Q segments, a batch row each
      const bool row_ok = p0 + q < x.nb;  // else this set idles
      const int p = row_ok ? p0 + q : p0;
      const long long b = x.b + p;
      if (t0 == 0) {              // the batch row begins
        ii = 0;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const int v = gl + k * L;
          if (v < nvec) {
            Vec<T>::unpack(*reinterpret_cast<const uint4*>(
                               item + b * dim + v * V), it[k]);
            Vec<T>::unpack(*reinterpret_cast<const uint4*>(
                               dout + b * dim + v * V), go[k]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) it[k][e] = go[k][e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < V; ++e) {
            di[k][e] = 0;
            ii += A(it[k][e]) * it[k][e];
          }
        }
        float cnt = 0.f;
        for (int t = lane % S; t < seq; t += S) cnt += mask[b * seq + t];
        ii = group_sum(ii, L);
        cnt = group_sum(cnt, S);
        ni = sqrt(ii > A(e2) ? ii : A(e2));
        rden_m = rcp_(A(fmaxf(cnt, 1.f)));
        dni = 0;
      }
      const T* seg = stage + static_cast<long long>(p) * (t1 - t0) * dim;
      T* dseg = d_beh + (b * seq + t0) * dim;
      const float* mrow = mask + b * seq;
      // U rows a group a trip (rows tt0 + u·Gq + gq), the same trips every
      // lane
      for (int tt0 = t0; tt0 < t1; tt0 += U * Gq) {
        // up to 4 rows stay in registers from the sums to the gradients;
        // more are loaded again from shared memory
        constexpr bool kReload = U > 4;
        float keep[kReload ? 1 : U][KC][V];
        float m[U], a[U], att[U];
        A dot[U], bb[U], gb[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int tt = tt0 + u * Gq + gq;
          const bool valid = row_ok && tt < t1;
          m[u] = valid ? mrow[tt] : 0.f;
          a[u] = valid ? att0[tt] : 0.f;
          float (&bv)[KC][V] = keep[kReload ? 0 : u];
          load_row<T, KC>(seg, tt - t0, dim, gl, L, nvec, valid, bv);
          dot[u] = bb[u] = gb[u] = 0;
#pragma unroll
          for (int k = 0; k < KC; ++k)
#pragma unroll
            for (int e = 0; e < V; ++e) {
              dot[u] += A(bv[k][e]) * it[k][e];
              bb[u] += A(bv[k][e]) * bv[k][e];
              gb[u] += A(bv[k][e]) * go[k][e];
            }
        }
        for (int o = L >> 1; o > 0; o >>= 1) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], o);
            bb[u] += __shfl_xor_sync(0xffffffffu, bb[u], o);
            gb[u] += __shfl_xor_sync(0xffffffffu, gb[u], o);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int tt = tt0 + u * Gq + gq;
          const bool valid = row_ok && tt < t1;
          const RowGrad<A> r =
              row_grad(dot[u], bb[u], gb[u], m[u], a[u], ni, rden_m);
          dni += r.dden_nb;
          float (&bv)[KC][V] = keep[kReload ? 0 : u];
          if (kReload)
            load_row<T, KC>(seg, tt - t0, dim, gl, L, nvec, valid, bv);
#pragma unroll
          for (int k = 0; k < KC; ++k) {
            float o[V];
#pragma unroll
            for (int e = 0; e < V; ++e) {
              o[e] = float(r.gmm * go[k][e] + r.ddot * it[k][e] +
                           r.cb * bv[k][e]);
              di[k][e] += r.ddot * bv[k][e];
            }
            const int v = gl + k * L;
            if (valid && v < nvec) {
              *reinterpret_cast<uint4*>(
                  dseg + static_cast<long long>(tt - t0) * dim + v * V) =
                  Vec<T>::pack(o);
            }
          }
          att[u] = float(r.att);
        }
        // the sets' d_att0 sums in batch-row order: set q adds after set
        // q - 1 (the same t may be in both)
        for (int qq = 0; qq < Q; ++qq) {
          if (q == qq && gl == 0) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int tt = tt0 + u * Gq + gq;
              if (row_ok && tt < t1) s_att[tt - tbase] += att[u];
            }
          }
          __syncwarp();
        }
      }
      __syncwarp();
      if (t1 == seq) {            // the batch row ends
        const A dni_all = across_groups(dni, L, S);
        const A ci = ii > A(e2) ? dni_all * rcp_(ni) : A(0);
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          float o[V];
#pragma unroll
          for (int e = 0; e < V; ++e)
            o[e] = float(across_groups(di[k][e], L, S) + ci * it[k][e]);
          const int v = gl + k * L;
          if (row_ok && gq == 0 && v < nvec)
            *reinterpret_cast<uint4*>(d_item + b * dim + v * V) =
                Vec<T>::pack(o);
        }
      }
    }
    if (plan.ntile > 1) {         // flush this T-tile's sums
      for (int i = lane; i < t1 - t0; i += 32) {
        float* q = partial + (tbase + i) * n_slots + slot;
        *q = (u < plan.ntile ? 0.f : *q) + s_att[i];
        s_att[i] = 0.f;
      }
    }
    ring.release(u, lane);
  }
  if (plan.ntile == 1) {
    for (int t = lane; t < seq; t += 32)
      partial[t * n_slots + slot] = s_att[t];
  }
}

// the generic path: one warp a batch row, element loads, outputs in
// chunks of kGenericChunk with the row sums recomputed for each chunk
template <typename T>
__device__ void bwd_generic(const T* __restrict__ dout,
                            const T* __restrict__ beh,
                            const T* __restrict__ item,
                            const float* __restrict__ att0,
                            const float* __restrict__ mask,
                            T* __restrict__ d_beh, T* __restrict__ d_item,
                            float* __restrict__ partial, long long batch,
                            int seq, int dim) {
  using A = typename Acc<T>::type;
  constexpr int E = kGenericPerLane;
  const int lane = threadIdx.x & 31;
  const long long slot =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long n_slots = static_cast<long long>(gridDim.x) * kWarps;
  const float e2 = kEps * kEps;
  if (slot >= batch) {
    for (int t = lane; t < seq; t += 32) partial[t * n_slots + slot] = 0.f;
    return;
  }
  for (long long b = slot; b < batch; b += n_slots) {
    const bool first = b == slot;
    const T* irow = item + b * dim;
    const T* grow = dout + b * dim;
    A ii = 0;
    float cnt = 0.f;
    for (int d = lane; d < dim; d += 32) {
      const float x = to_f32(irow[d]);
      ii += A(x) * x;
    }
    for (int t = lane; t < seq; t += 32) cnt += mask[b * seq + t];
    ii = group_sum(ii, 32);
    const A ni = sqrt(ii > A(e2) ? ii : A(e2));
    const A rden_m = rcp_(A(fmaxf(group_sum(cnt, 32), 1.f)));
    for (int c0 = 0; c0 < dim; c0 += kGenericChunk) {
      float it[E], go[E];
      A di[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = c0 + lane + 32 * e;
        it[e] = d < dim ? to_f32(irow[d]) : 0.f;
        go[e] = d < dim ? to_f32(grow[d]) : 0.f;
        di[e] = 0;
      }
      A dni = 0;
      for (int t = 0; t < seq; ++t) {
        const T* row = beh + (b * seq + t) * dim;
        A dot = 0, bb = 0, gb = 0;
        for (int d = lane; d < dim; d += 32) {
          const float x = to_f32(row[d]);
          dot += A(x) * to_f32(irow[d]);
          bb += A(x) * x;
          gb += A(x) * to_f32(grow[d]);
        }
        for (int o = 16; o > 0; o >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
          bb += __shfl_xor_sync(0xffffffffu, bb, o);
          gb += __shfl_xor_sync(0xffffffffu, gb, o);
        }
        const RowGrad<A> r = row_grad(dot, bb, gb, mask[b * seq + t],
                                      att0[t], ni, rden_m);
        dni += r.dden_nb;
        T* drow = d_beh + (b * seq + t) * dim;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = c0 + lane + 32 * e;
          if (d < dim) {
            const float x = to_f32(row[d]);
            store(drow + d, float(r.gmm * go[e] + r.ddot * it[e] + r.cb * x));
            di[e] += r.ddot * x;
          }
        }
        if (c0 == 0 && lane == 0) {
          float* p = partial + t * n_slots + slot;
          *p = (first ? 0.f : *p) + float(r.att);
        }
      }
      const A ci = ii > A(e2) ? dni / ni : A(0);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = c0 + lane + 32 * e;
        if (d < dim) store(d_item + b * dim + d, float(di[e] + ci * it[e]));
      }
    }
  }
}

template <typename T, int KC, int U>
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSM)
din_bwd_kernel(const T* __restrict__ dout, const T* __restrict__ beh,
               const T* __restrict__ item, const float* __restrict__ att0,
               const float* __restrict__ mask, T* __restrict__ d_beh,
               T* __restrict__ d_item, float* __restrict__ partial,
               long long batch, int seq, int dim, Plan plan) {
  if constexpr (KC == 0) {
    bwd_generic<T>(dout, beh, item, att0, mask, d_beh, d_item, partial,
                   batch, seq, dim);
  } else {
    bwd_ring<T, KC, U>(dout, beh, item, att0, mask, d_beh, d_item, partial,
                       batch, seq, dim, plan);
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

template <typename T, int KC, int U>
cudaError_t run(Plan& p, int n_sms, cudaStream_t s, const T* go, const T* bp,
                const T* ip, const float* ap, const float* mp, T* dbp,
                T* dip, float* part, long long batch, int seq, int dim) {
  auto kernel = din_bwd_kernel<T, KC, U>;
  const cudaError_t e = fit(kernel, p, n_sms);
  if (e != cudaSuccess) return e;
  kernel<<<p.grid, kWarps * 32, p.smem, s>>>(go, bp, ip, ap, mp, dbp, dip,
                                              part, batch, seq, dim, p);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* dout, const void* beh, const void* item,
           const void* att0, const void* mask, void* d_beh, void* d_item,
           void* d_att0, void* partial, long long batch, int seq, int dim,
           void* stream, int n_sms) {
  if (dim < 1 || seq < 1 || batch <= 0 || n_sms < 1)
    return cudaErrorInvalidValue;
  const bool fast = aligned16(dout) && aligned16(beh) && aligned16(item) &&
                    aligned16(d_beh) && aligned16(d_item);
  Plan p = make_plan(batch, seq, dim, sizeof(T), fast, n_sms);
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
  if (p.kc == 1 && p.rows_at_once == 8) {
    e = run<T, 1, 8>(p, n_sms, s, go, bp, ip, ap, mp, dbp, dip, part, batch,
                     seq, dim);
  } else if (p.kc == 1 && p.rows_at_once == 4) {
    e = run<T, 1, 4>(p, n_sms, s, go, bp, ip, ap, mp, dbp, dip, part, batch,
                  seq, dim);
  } else if (p.kc == 1 && p.rows_at_once == 2) {
    e = run<T, 1, 2>(p, n_sms, s, go, bp, ip, ap, mp, dbp, dip, part, batch,
                  seq, dim);
  } else if (p.kc == 1) {
    e = run<T, 1, 1>(p, n_sms, s, go, bp, ip, ap, mp, dbp, dip, part, batch,
                  seq, dim);
  } else if (p.kc == 2 && p.rows_at_once == 2) {
    e = run<T, 2, 2>(p, n_sms, s, go, bp, ip, ap, mp, dbp, dip, part, batch,
                  seq, dim);
  } else if (p.kc == 2) {
    e = run<T, 2, 1>(p, n_sms, s, go, bp, ip, ap, mp, dbp, dip, part, batch,
                  seq, dim);
  } else {
    e = run<T, 0, 1>(p, n_sms, s, go, bp, ip, ap, mp, dbp, dip, part, batch,
                  seq, dim);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  att0_reduce_kernel<<<seq, kReduceThreads, 0, s>>>(
      part, static_cast<float*>(d_att0), p.grid * kWarps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// partial: f32 scratch of seq · kWarps · min(kBlocksPerSM · n_sms,
// ceil(batch / kWarps)) floats; n_sms: the card's SM count.
extern "C" int din_attention_bwd_f32(const void* dout, const void* beh,
                                     const void* item, const void* att0,
                                     const void* mask, void* d_beh,
                                     void* d_item, void* d_att0, void* partial,
                                     long long batch, int seq, int dim,
                                     void* stream, int n_sms) {
  return launch<float>(dout, beh, item, att0, mask, d_beh, d_item, d_att0,
                       partial, batch, seq, dim, stream, n_sms);
}

extern "C" int din_attention_bwd_bf16(const void* dout, const void* beh,
                                      const void* item, const void* att0,
                                      const void* mask, void* d_beh,
                                      void* d_item, void* d_att0, void* partial,
                                      long long batch, int seq, int dim,
                                      void* stream, int n_sms) {
  return launch<__nv_bfloat16>(dout, beh, item, att0, mask, d_beh, d_item,
                               d_att0, partial, batch, seq, dim, stream,
                               n_sms);
}

extern "C" const char* din_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
