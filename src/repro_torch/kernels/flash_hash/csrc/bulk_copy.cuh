// Hopper (sm_90a) 1-D bulk copies into shared memory, counted on mbarriers,
// and out of it, in bulk groups, in inline PTX. Included by flash_hash.cu;
// nothing here launches or allocates.
//
// A bulk copy moves a contiguous run of bytes from device memory into
// shared memory without registers or per-thread instructions; its size and
// both addresses must be multiples of 16 bytes. Completion is counted in
// bytes on an mbarrier that one thread armed with arrive_expect_tx; every
// thread that waits on the barrier's phase then sees the data.
#pragma once

#include <stdint.h>

namespace bulk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of copies to come (0 completes
// the phase at once).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Copies `bytes` (a multiple of 16) from `src` to shared memory at `dst`,
// both 16-byte aligned; completion is counted on `bar`.
__device__ __forceinline__ void copy_to_smem(void* dst, const void* src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Orders the generic proxy's memory accesses before it (plain stores, in
// this CTA's shared memory or, through a cluster barrier, another CTA's)
// before the async proxy's after it (a bulk copy out of shared memory).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// Copies `bytes` (a multiple of 16) from shared memory at `src` to `dst`,
// both 16-byte aligned, in the calling thread's bulk group.
__device__ __forceinline__ void copy_to_global(void* dst, const void* src,
                                               uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          reinterpret_cast<uint64_t>(dst)),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

// Closes the calling thread's bulk group and returns once every copy of
// it has read its shared memory (which may then be reused or released).
__device__ __forceinline__ void commit_and_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

}  // namespace bulk
