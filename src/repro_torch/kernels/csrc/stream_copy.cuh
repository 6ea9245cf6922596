// Asynchronous global -> shared copies that complete on an mbarrier
// (sm_90): the barrier's init, arrive, expect-tx and parity wait; the TMA
// engine's bulk copy of contiguous bytes (cp.async.bulk: both addresses
// 16-byte aligned, a multiple of 16 bytes, no registers or per-element
// instructions spent on it); and 8- or 4-byte cp.async whose completion a
// thread hands to a barrier (cp.async.mbarrier.arrive.noinc), for rows
// that are not 16-byte aligned.
//
// A ring of stages keeps two barriers a stage: "full" completes when the
// stage's bytes have landed (the bulk copies' transaction count, or the
// copying lanes' asynchronous arrivals), "empty" when every consumer has
// read it.  Phase parity: a barrier starts in phase 0; waiting on parity
// p returns once phase p has completed, so the n-th use of a slot (from
// 0) waits on parity n & 1.
#pragma once

#include <stdint.h>

#include "mma_tile.cuh"

namespace stream_copy {

using mma_tile::smem_u32;

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :
               : "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the asynchronous proxy; a
// __syncthreads after it shows them to the block's threads
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :
               : "r"(smem_u32(bar))
               : "memory");
}

// one arrival, and `bytes` more to land before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from src to dst, both 16-byte aligned; the
// landed bytes count down the barrier's expected transactions
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :
      : "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async_8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :
               : "r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// one arrival on the barrier once this thread's earlier cp.async copies
// have landed (the barrier's count includes it)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :
               : "r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace stream_copy
