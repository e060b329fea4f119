// Cumsum-difference row update of the packed [V, 128] table (K7).
//
// Replaces: goctr_tpu/ops/pallas/row_optimizer.py::_csum_kernel /
// apply_csum_updates (pallas_call at :393), the table update of
// update_mode="fused2" (goctr_tpu/parallel/scanned.py:189-212).
//
// Input: ids [n] int32 sorted ascending (pads carry id >= skip_ge and sort
// last; duplicates adjacent), c [n, d] f32, the inclusive cumsum of the
// sorted gradient rows (zero rows for pads), and the table [V, 128] f32
// (w | acc | 0), updated in place. At each position j that ends a run
// (j = n−1 or ids[j+1] != ids[j]) of a real id (0 <= id < skip_ge):
//   Σg = c[j] − c[p],  p the previous real run end (none: Σg = c[j]),
// then the row-wise adagrad or sgd update of line ids[j] (line_update.cuh).
// The subtraction is the one the plain version does on the same c, so Σg
// is the same bits; only ‖Σg‖² (another order of d adds) and rsqrtf may
// differ from it.
//
// The TPU kernel walks the positions in grid order and carries the last
// real run end's cumsum row in the prev_c register across grid steps
// (:288-291, :330-332). CUDA blocks run in no order, so each run end
// finds its previous real end without that state: ids are sorted, so
// every position before the run's first position p+1 holds a smaller id,
// which is real unless negative; the previous real end is therefore p, the
// position before the run's start, when ids[p] >= 0, and none otherwise.
// Pads sort last and never become a previous end.
//
// What bounds it on the H100: bytes. It reads the ids, one c row per real
// run end (the row a later run reads as its previous end is that run's
// own), and reads and writes the 32-byte sectors of each real line that
// hold its d+1 live lanes. At the headline's first step (n = 2,162,688
// ids, 519,364 real runs, d = 64: 256 B of c and 288 B of line a run)
// that is ~0.44 GB, ~0.13 ms at 3.35 TB/s. The arithmetic (a few flops a
// lane) is negligible.
// Design: one warp per 32 positions. Each thread reads its id and its
// neighbours' and the warp ballots the run starts and the real run ends.
// A run end whose run starts inside the 32 positions takes the nearest
// start bit below it; the run open at the warp's first position (at most
// one a warp, and any length: zipf runs reach ~10^5 rows) finds its first
// position with a 32-ary search of the ids by the whole warp, ~5 rounds
// of one load a thread, never a walk over the run. The warp then takes
// its real run ends kBatch at a time: it issues the loads of their lines,
// c rows and previous-end c rows together, then computes and stores them.
// Plain version: apply_csum_updates_plain in
// goctr_tpu_torch/ops/kernels/row_optimizer.py.
#include <cuda_runtime.h>

#include "line_update.cuh"

namespace {

using line_update::Batch;
using line_update::kBatch;
using line_update::kFull;

constexpr int kWarpsPerBlock = 8;

// The first position in [0, hi] whose id is >= key, by the whole warp.
// ids[0 .. hi] are sorted and ids[hi] >= key.
__device__ long long first_at_least(const int* __restrict__ ids, long long hi,
                                    int key, int lane) {
  long long lo = 0;  // every position below lo holds an id < key
  while (lo < hi) {
    // probes lo, lo + step, ..., clamped at hi: lane 31's is hi
    const long long step = (hi - lo + 30) / 31;
    const long long q = lo + step * lane < hi ? lo + step * lane : hi;
    const unsigned ge = __ballot_sync(kFull, __ldg(ids + q) >= key);
    const int f = __ffs(ge) - 1;
    if (f == 0) return lo;
    const long long q_f = lo + step * f;
    hi = q_f < hi ? q_f : hi;
    lo = lo + step * (f - 1) + 1;
  }
  return lo;
}

template <bool kAdagrad>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csum_kernel(float* __restrict__ table, const int* __restrict__ ids,
            const float* __restrict__ c, long long n, int d, long long skip_ge,
            float lr, float eps) {
  const int lane = threadIdx.x & 31;
  const long long j0 =
      (static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32) * 32;
  if (j0 >= n) return;  // the whole warp
  const long long j = j0 + lane;
  int id = 0;
  bool start = false, real = false;
  if (j < n) {
    id = __ldg(ids + j);
    start = j == 0 || __ldg(ids + j - 1) != id;
    const bool end = j == n - 1 || __ldg(ids + j + 1) != id;
    real = end && id >= 0 && id < skip_ge;
  }
  const unsigned starts = __ballot_sync(kFull, start);
  unsigned rest = __ballot_sync(kFull, real);
  if (rest == 0) return;
  // first position of the run open at j0
  const long long open_start =
      (starts & 1u) ? j0 : first_at_least(ids, j0, __shfl_sync(kFull, id, 0), lane);
  while (rest) {
    Batch b;
    b.count = 0;
    long long pos[kBatch], prev[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      pos[i] = prev[i] = -1;
      if (rest == 0) continue;
      const int r = __ffs(rest) - 1;
      rest &= rest - 1;
      const unsigned below = starts & (r == 31 ? kFull : (2u << r) - 1u);
      const long long run_start = below ? j0 + (31 - __clz(below)) : open_start;
      pos[i] = j0 + r;
      if (run_start > 0 && __ldg(ids + run_start - 1) >= 0) prev[i] = run_start - 1;
      b.id[i] = __shfl_sync(kFull, id, r);
      b.count = i + 1;
    }
    // every load of the batch before any compute
    float4 t[kBatch];
    line_update::load_lines(table, b, d, lane, t);
    float cj[kBatch][4], cp[kBatch][4];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int dim = 4 * lane + k;
        cj[i][k] = cp[i][k] = 0.f;
        if (pos[i] >= 0 && dim < d) cj[i][k] = __ldg(c + pos[i] * d + dim);
        if (prev[i] >= 0 && dim < d) cp[i][k] = __ldg(c + prev[i] * d + dim);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) b.g[i][k] = __fsub_rn(cj[i][k], cp[i][k]);
    }
    line_update::update_lines<kAdagrad>(table, b, t, d, lr, eps, lane);
  }
}

}  // namespace

// table [V, 128] f32 (16-byte aligned), ids [n] int32 sorted, c [n, d]
// f32; 0 < d < 128, skip_ge <= V. Returns cudaGetLastError() after the
// launch.
extern "C" int csum_rmw(void* table, const void* ids, const void* c,
                        long long n, int d, long long skip_ge, int adagrad,
                        float lr, float eps, void* stream) {
  if (d <= 0 || d >= line_update::kLanes) return cudaErrorInvalidValue;
  if (n <= 0) return 0;
  constexpr long long kPerBlock = kWarpsPerBlock * 32;
  const dim3 grid(static_cast<unsigned>((n + kPerBlock - 1) / kPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  auto* t = static_cast<float*>(table);
  const auto* i = static_cast<const int*>(ids);
  const auto* cr = static_cast<const float*>(c);
  auto s = static_cast<cudaStream_t>(stream);
  if (adagrad) {
    csum_kernel<true><<<grid, block, 0, s>>>(t, i, cr, n, d, skip_ge, lr, eps);
  } else {
    csum_kernel<false><<<grid, block, 0, s>>>(t, i, cr, n, d, skip_ge, lr, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* csum_rmw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
