// Write-only row scatter into the packed [V, 128] f32 table (K4).
//
// Replaces: goctr_tpu/ops/pallas/row_optimizer.py::_scatter_kernel /
// scatter_rows_packed (pallas_call at :824), the write-back half of the
// split row update apply_row_updates_split (:843-867).
//
// Computes table[ids[j]] = rows[j] for every j with 0 <= ids[j] < skip_ge,
// in place. ids of real rows are pairwise distinct (the update stream is
// deduplicated before it), so rows need no order among themselves. An id
// >= skip_ge (junk targets V+1+k, which point past the table) is skipped
// before any table address is formed; so is a negative id. The caller
// keeps skip_ge <= V, so every address formed lies inside the table.
//
// What bounds it on the H100: bytes. Each real row reads its 512-byte
// update row and writes one 512-byte table line; skipped rows cost their
// 4-byte id. At the headline training step (~17% of 2,162,688 update
// positions unique, compacted to ~0.4M slots) that is ~0.4 GB, ~0.12 ms at
// 3.35 TB/s.
// Design: the TPU kernel issues one row DMA at a time from its scalar core
// through a ring of 16 semaphores (:768-804). Here one warp owns one row:
// lane l moves 16 bytes (one float4) of the 512-byte line, so a row is one
// fully coalesced load and one fully coalesced store, and the card keeps
// as many rows in flight as it has warps resident. No ordering between
// rows, no atomics (ids are distinct).
// Plain version: scatter_rows_packed_plain in
// goctr_tpu_torch/ops/kernels/row_optimizer.py (`index_put_` of the real
// rows).
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kLanes = 128;  // floats per packed line: 32 lanes x float4

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
row_scatter_kernel(float* __restrict__ table, const int* __restrict__ ids,
                   const float* __restrict__ rows, long long n,
                   long long skip_ge) {
  const long long j =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (j >= n) return;
  const int id = __ldg(ids + j);
  if (id < 0 || id >= skip_ge) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const float4 v = __ldg(reinterpret_cast<const float4*>(rows + j * kLanes) + lane);
  reinterpret_cast<float4*>(table + static_cast<long long>(id) * kLanes)[lane] = v;
}

}  // namespace

// table [V, 128] f32, ids [n] int32, rows [n, 128] f32; all 16-byte
// aligned; skip_ge <= V.
extern "C" int row_scatter(void* table, const void* ids, const void* rows,
                           long long n, long long skip_ge, void* stream) {
  if (n <= 0) return 0;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock));
  row_scatter_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table), static_cast<const int*>(ids),
      static_cast<const float*>(rows), n, skip_ge);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* row_scatter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
