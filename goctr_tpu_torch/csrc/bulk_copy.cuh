// Hopper's bulk copies from global to shared memory, completed on an
// mbarrier: what the DIN pool's ring (din_pool.cuh, K2 and K2b) and the
// sorted-run update's ring (run_rmw.cu, K8) share.
//
// A stage of a ring is a buffer in shared memory and one mbarrier (count
// 1). Lane 0 arms the barrier with the bytes it expects and issues the
// copy (bulk_load), or arrives with nothing to copy (arrive); the warp
// waits on the barrier's phase parity (wait), which flips once a phase's
// bytes have landed.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bulk_copy {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Lane 0: the stage's barrier expects `bytes`, and the bulk copy of
// `bytes` (a multiple of 16, both addresses 16-B aligned) from global
// memory completes them.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  // order this warp's earlier reads of the stage before the async write
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Lane 0: complete the stage's phase with nothing copied.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
      :: "r"(smem_addr(bar)) : "memory");
}

// Wait for the phase of `parity` to complete. A copy that never lands
// traps after ~2^34 clock ticks (seconds) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

}  // namespace bulk_copy
