// One-dimensional bulk copies from global to shared memory on Hopper's copy
// engine (cp.async.bulk, the TMA's non-tensor form), completed on an
// mbarrier in shared memory. One thread issues a whole run of 16-byte
// chunks with one instruction; the threads that need the data wait on the
// barrier's phase.
//
// Rules of the instruction: the source and destination addresses and the
// byte count are multiples of 16.

#pragma once

#include <cstdint>

namespace ipt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: the barrier completes its phase after `arrivals` arrivals and
// the bytes they announced. The caller synchronises the block before use.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(arrivals)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that announces `bytes` more bytes to come by bulk_load.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

// Wait until the phase with the given parity (0 for the first) has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
    } while (!done);
}

// Orders the thread's earlier generic-proxy accesses to shared memory before
// its later bulk copies into it (a buffer that is reused).
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Copy `bytes` from global `src` to shared `dst`; completion counts on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

}  // namespace ipt
