// The row update of packed [V, 128] f32 lines (w | acc | 0) from run sums,
// shared by csum_rmw.cu (K7) and run_rmw.cu (K8): the body of K5
// (row_rmw.cu) at one group a line, with Σg given per dim instead of as a
// packed update row, and ‖Σg‖² summed here.
//
// For a line t of id and its run sum g (d dims):
//   adagrad: a = t[d] + ‖g‖²;  t'[k] = t[k] − (lr · rsqrt(a + eps)) · g[k]
//            for k < d;  t'[d] = a
//   sgd:     t'[k] = t[k] − lr · g[k] for k < d
// and every other lane is neither read nor written. Every product and sum
// is rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn, never
// contracted into an fma), term by term as the JAX kernels
// (goctr_tpu/ops/pallas/row_optimizer.py:333-342,
// goctr_tpu/ops/pallas/run_optimizer.py:165-172) and the plain versions
// compute them; ‖g‖² adds the d squares in another order (each thread's
// four, then a shuffle tree), so the accumulator may differ by an ulp.
//
// A warp updates one line at a time (update_line): thread l holds lanes
// 4l … 4l+3 of the line as one float4 and dims 4l … 4l+3 of g (zero past
// d); threads whose four lanes all lie past lane d load and store
// nothing. Its caller issues several lines' loads (load_line) before it
// updates the first: K7 and K8's heads up to kBatch lines at a time (a
// Batch), K8's tile pass its own lines in flight. The lines a warp
// updates are distinct lines below the table's rows, and no other warp
// touches them: no atomics. Line offsets are 64-bit.
#pragma once

#include <cuda_runtime.h>

namespace line_update {

constexpr int kLanes = 128;  // floats per line: 32 threads x float4
constexpr int kBatch = 4;    // lines a warp loads before it computes
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Up to kBatch (line id, this thread's four dims of Σg) pending updates.
// `count` is the same in every thread of the warp.
struct Batch {
  int id[kBatch];
  float g[kBatch][4];
  int count;
};

// Append (id, g) to the batch; the slot is picked with constant indices so
// the arrays stay in registers.
__device__ __forceinline__ void push(Batch& b, int id, const float g[4]) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    if (i == b.count) {
      b.id[i] = id;
#pragma unroll
      for (int k = 0; k < 4; ++k) b.g[i][k] = g[k];
    }
  }
  ++b.count;
}

__device__ __forceinline__ bool live(int d, int lane) {
  return 4 * lane < d + 1;
}

// This thread's four lanes of line id (zeros where not live).
__device__ __forceinline__ float4 load_line(const float* table, int id, int d,
                                            int lane) {
  return live(d, lane) ? reinterpret_cast<const float4*>(
                             table + static_cast<long long>(id) * kLanes)[lane]
                       : make_float4(0.f, 0.f, 0.f, 0.f);
}

// This thread's four lanes of the batch's lines (zeros where not live).
__device__ __forceinline__ void load_lines(const float* table, const Batch& b,
                                           int d, int lane,
                                           float4 t[kBatch]) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i)
    t[i] = i < b.count ? load_line(table, b.id[i], d, lane)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Update and store line `id` from this thread's loaded lanes t and dims g
// of its run sum. Every thread of the warp calls it (it shuffles).
template <bool kAdagrad>
__device__ __forceinline__ void update_line(float* table, int id,
                                            const float4& t, const float g[4],
                                            int d, float lr, float eps,
                                            int lane) {
  float out[4];
  if (kAdagrad) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) s = __fadd_rn(s, __fmul_rn(g[k], g[k]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
    const float a = __fadd_rn(__shfl_sync(kFull, comp(t, d & 3), d >> 2), s);
    const float scale = __fmul_rn(lr, rsqrtf(__fadd_rn(a, eps)));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * lane + k;
      out[k] = c < d ? __fsub_rn(comp(t, k), __fmul_rn(scale, g[k]))
                     : c == d ? a : comp(t, k);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * lane + k;
      out[k] = c < d ? __fsub_rn(comp(t, k), __fmul_rn(lr, g[k]))
                     : comp(t, k);
    }
  }
  if (live(d, lane))
    reinterpret_cast<float4*>(table + static_cast<long long>(id) * kLanes)[lane] =
        make_float4(out[0], out[1], out[2], out[3]);
}

// Update and store the batch's lines from their loaded lanes t; empties
// the batch. Every thread of the warp calls it (it shuffles).
template <bool kAdagrad>
__device__ __forceinline__ void update_lines(float* table, Batch& b,
                                             const float4 t[kBatch], int d,
                                             float lr, float eps, int lane) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    if (i >= b.count) break;
    update_line<kAdagrad>(table, b.id[i], t[i], b.g[i], d, lr, eps, lane);
  }
  b.count = 0;
}

// Load, update and store the batch's lines.
template <bool kAdagrad>
__device__ __forceinline__ void flush(float* table, Batch& b, int d, float lr,
                                      float eps, int lane) {
  float4 t[kBatch];
  load_lines(table, b, d, lane, t);
  update_lines<kAdagrad>(table, b, t, d, lr, eps, lane);
}

}  // namespace line_update
