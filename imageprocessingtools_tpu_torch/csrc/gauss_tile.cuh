// The arithmetic of the 5x5 binomial (1,4,6,4,1)^2, (acc + 128) >> 8, on 8
// columns per thread in the 16-bit halves of registers, and the loads and
// stores of such a run: shared by K2 and K6 (gray_gauss_hist.cu) and K5
// (stencil.cu).
//
// Exact with no carry between halves: a horizontal sum is at most
// 16 * 255 = 4,080, and five rows of them with the rounding 128 at most
// 16 * 4,080 + 128 = 65,408 < 2^16.

#pragma once

#include <cstdint>

namespace ipt {

constexpr int RUN = 8;  // outputs per thread per row

// The horizontal 1-4-6-4-1 sums of columns x .. x + 7 from the values of
// columns x - 4 .. x + 11, four at a time with even and odd columns apart
// (e = (c, c + 2) and o = (c + 1, c + 3) for columns c .. c + 3): (e0, o0)
// for x - 4 .. x - 1, of which only the high halves count, then (e1, o1),
// (e2, o2) and (e3, o3), of which only the low halves count. They come as
// four registers of two 16-bit halves: h[0] = (x, x + 2), h[1] = (x + 1,
// x + 3), h[2] = (x + 4, x + 6), h[3] = (x + 5, x + 7). With z[n] = (g[x + n
// - 2], g[x + n]), h[m] = z[n] + 4 z[n + 1] + 6 z[n + 2] + 4 z[n + 3] +
// z[n + 4] for n = 0, 1, 4, 5.
__device__ __forceinline__ void hsum8(uint32_t e0, uint32_t o0, uint32_t e1, uint32_t o1,
                                      uint32_t e2, uint32_t o2, uint32_t e3, uint32_t o3,
                                      uint32_t* h) {
    const uint32_t z[10] = {
        __funnelshift_r(e0, e1, 16), __funnelshift_r(o0, o1, 16), e1, o1,
        __funnelshift_r(e1, e2, 16), __funnelshift_r(o1, o2, 16), e2, o2,
        __funnelshift_r(e2, e3, 16), __funnelshift_r(o2, o3, 16)};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
        const int n = (m & 1) + 4 * (m >> 1);
        h[m] = (z[n] + z[n + 4]) + 4u * (z[n + 1] + z[n + 3]) + 6u * z[n + 2];
    }
}

// Four columns c .. c + 3 packed as e and o, of which the first n lie
// inside the image: the others take `last`, the last column's value.
__device__ __forceinline__ void clamp_right(uint32_t& e, uint32_t& o, int n, uint32_t last) {
    const uint32_t both = last * 0x00010001u;
    const uint32_t keep_e = (n >= 1 ? 0x0000FFFFu : 0u) | (n >= 3 ? 0xFFFF0000u : 0u);
    const uint32_t keep_o = (n >= 2 ? 0x0000FFFFu : 0u) | (n >= 4 ? 0xFFFF0000u : 0u);
    e = (e & keep_e) | (both & ~keep_e);
    o = (o & keep_o) | (both & ~keep_o);
}

// Stores the run's n <= 8 bytes (lo: bytes 0-3, hi: 4-7) at dst.
template <bool kAligned>
__device__ __forceinline__ void store_run(uint8_t* dst, uint32_t lo, uint32_t hi, int n) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
    if (n == RUN && (kAligned || (a & 7) == 0)) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
    } else if (n == RUN && (a & 3) == 0) {
        reinterpret_cast<uint32_t*>(dst)[0] = lo;
        reinterpret_cast<uint32_t*>(dst)[1] = hi;
    } else {
#pragma unroll
        for (int k = 0; k < RUN; ++k) {
            if (k < n) dst[k] = static_cast<uint8_t>((k < 4 ? lo : hi) >> (8 * (k & 3)));
        }
    }
}

// The n (even) words of bytes p .. p + 4 n - 1, p 8-byte aligned when kAligned.
template <bool kAligned, int n>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t* w) {
    if (kAligned) {
#pragma unroll
        for (int i = 0; i < n; i += 2) {
            const uint2 q = reinterpret_cast<const uint2*>(p)[i / 2];
            w[i] = q.x;
            w[i + 1] = q.y;
        }
    } else {
        const uint32_t* a = reinterpret_cast<const uint32_t*>(reinterpret_cast<uintptr_t>(p) & ~uintptr_t{3});
        const int sh = 8 * static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
        uint32_t v[n + 1];
#pragma unroll
        for (int i = 0; i <= n; ++i) v[i] = a[i];
#pragma unroll
        for (int i = 0; i < n; ++i) w[i] = __funnelshift_r(v[i], v[i + 1], sh);
    }
}

// The outputs of columns x .. x + 7 (lo: x .. x + 3, hi: x + 4 .. x + 7)
// from five rows a .. e of their horizontal sums as hsum8 packs them: the
// vertical 1-4-6-4-1 sum and 128 in the same halves; each half's upper byte
// is its rounded output, (acc + 128) >> 8.
__device__ __forceinline__ void vsum8(const uint32_t* a, const uint32_t* b, const uint32_t* c,
                                      const uint32_t* d, const uint32_t* e, uint32_t& lo,
                                      uint32_t& hi) {
    uint32_t acc[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
        acc[m] = (a[m] + e[m] + 0x00800080u) + 4u * (b[m] + d[m]) + 6u * c[m];
    }
    lo = __byte_perm(acc[0], acc[1], 0x7351);
    hi = __byte_perm(acc[2], acc[3], 0x7351);
}

}  // namespace ipt
