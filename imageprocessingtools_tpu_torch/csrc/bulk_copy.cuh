// One-dimensional bulk copies from global to shared memory on Hopper's copy
// engine (cp.async.bulk, the TMA's non-tensor form), completed on an
// mbarrier in shared memory. One thread issues a whole run of 16-byte
// chunks with one instruction; the threads that need the data wait on the
// barrier's phase. stage_row is the use K2, K6 (gray_gauss_hist.cu) and K5
// (stencil.cu) make of it: one halo row of a tile per thread.
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

// One thread stages bytes base .. base + 16 kChunks - 1 of a row of `bytes`
// bytes at dst (row + base and dst are 16-byte aligned; base may be negative
// and the row may end early): the chunks that lie inside the row go in one
// bulk copy, and the bytes inside the row of the (at most two) chunks that
// straddle its first or last byte are copied one by one. Nothing outside the
// row is read; those bytes of dst keep what they held. The thread arrives
// once on `bar`.
template <int kChunks>
__device__ __forceinline__ void stage_row(uint8_t* dst, const uint8_t* row, int base, int bytes,
                                          uint64_t* bar) {
    const int lo = base >= 0 ? 0 : (15 - base) / 16;  // first chunk from row byte 0 on
    const int hi = min(kChunks, (bytes - base) / 16);  // chunks that end by the row's end
    const int n = max(hi - lo, 0);
    fence_proxy_async();  // after the block's last generic access to dst
    mbar_arrive_expect_tx(bar, 16 * n);
    if (n) bulk_load(dst + 16 * lo, row + base + 16 * lo, 16 * n, bar);
    auto copy_bytes = [&](int j) {  // the bytes of chunk j inside the row
        for (int c = max(base + 16 * j, 0); c < min(base + 16 * j + 16, bytes); ++c) {
            dst[c - base] = __ldg(row + c);
        }
    };
    if (lo > 0) copy_bytes(lo - 1);                    // holds row byte 0
    if (hi < kChunks && hi != lo - 1) copy_bytes(hi);  // the row's last bytes, if any
}

}  // namespace ipt
