// K8: grayscale of interleaved RGB, then a static pointwise chain.
//
// Replaces the Pallas kernel
//   imageprocessingtools_tpu/kernels/pallas_core.py::fused_elementwise_pallas
// (body _elementwise_kernel). The TPU form took three planar uint8[H, W]
// planes (the lane layout wants one channel per plane), padded rows to a
// block multiple and evaluated the chain (invert, brightness, contrast in
// f32, threshold) on int32 vregs. Here:
//
// - the input is the interleaved uint8[..., 3] image as it lies in memory,
//   read as n = numel / 3 pixels whatever the leading dims;
// - every intermediate of the chain is an integer in [0, 255], so the whole
//   chain is a function of the gray byte alone. The wrapper evaluates the
//   chain's own arithmetic once on the 256 gray values (contrast as separate
//   f32 subtract, multiply and add, so no FMA contraction can move a
//   floor(x + 0.5)) and passes that uint8[256] table; the kernel computes
//   (r+g+b)/3 and looks it up in shared memory. The empty chain (grayscale
//   alone) is a second instance that takes no table;
// - on 16-byte-aligned buffers each thread maps 16 pixels per step: three
//   16-byte loads (48 bytes of RGB) and one 16-byte store; a byte-wise loop
//   takes the tail and unaligned buffers.
//
// What bounds it on an H100: bytes (3 read and 1 written per pixel: 24.9 MB
// in and 8.3 MB out at 4K, 9.9 us at 3.35 TB/s). Neighbouring threads read
// 48-byte strides, so each load instruction touches every other 16-byte
// chunk; the three loads of a warp together cover whole sectors.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 16;  // pixels per thread step on the aligned path

__device__ __forceinline__ uint32_t byte_of(const uint32_t (&w)[12], int k) {
    return (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
}

template <bool kTable>
__device__ __forceinline__ uint32_t gray_then_chain(uint32_t r, uint32_t g, uint32_t b,
                                                    const uint8_t* table) {
    const uint32_t v = (r + g + b) / 3;
    if constexpr (kTable) return table[v];
    return v;
}

template <bool kTable>
__global__ void __launch_bounds__(THREADS)
elementwise_kernel(const uint8_t* __restrict__ rgb, uint8_t* __restrict__ out,
                   const uint8_t* __restrict__ table, long long n, long long n_vec) {
    __shared__ uint8_t stable[kTable ? 256 : 1];
    if constexpr (kTable) {
        for (int i = threadIdx.x; i < 256; i += THREADS) stable[i] = table[i];
        __syncthreads();
    }

    const long long stride = static_cast<long long>(gridDim.x) * THREADS;
    const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
    const uint4* src4 = reinterpret_cast<const uint4*>(rgb);
    uint4* out4 = reinterpret_cast<uint4*>(out);
    for (long long i = tid; i < n_vec; i += stride) {
        const uint4 a = __ldg(src4 + 3 * i);
        const uint4 b = __ldg(src4 + 3 * i + 1);
        const uint4 c = __ldg(src4 + 3 * i + 2);
        const uint32_t w[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
        uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int p = 0; p < VEC; ++p) {
            const uint32_t v = gray_then_chain<kTable>(
                byte_of(w, 3 * p), byte_of(w, 3 * p + 1), byte_of(w, 3 * p + 2), stable);
            o[p >> 2] |= v << (8 * (p & 3));
        }
        out4[i] = make_uint4(o[0], o[1], o[2], o[3]);
    }
    for (long long i = n_vec * VEC + tid; i < n; i += stride) {
        const uint8_t* p = rgb + 3 * i;
        out[i] = static_cast<uint8_t>(gray_then_chain<kTable>(__ldg(p), __ldg(p + 1),
                                                              __ldg(p + 2), stable));
    }
}

}  // namespace

// rgb uint8[n, 3] -> out uint8[n]; table uint8[256] or null for the empty
// chain (grayscale alone).
extern "C" int ipt_fused_elementwise(const void* rgb, void* out, const void* table,
                                     long long n, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool aligned = (reinterpret_cast<uintptr_t>(rgb) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    const long long n_vec = aligned ? n / VEC : 0;
    // One step per thread where the buffers are aligned, else one pixel per
    // thread; capped, and a grid-stride loop covers the rest.
    const long long work = aligned ? n_vec + (n - n_vec * VEC) : n;
    long long blocks = (work + THREADS - 1) / THREADS;
    if (blocks < 1) blocks = 1;
    if (blocks > 65535) blocks = 65535;
    const auto* src = static_cast<const uint8_t*>(rgb);
    auto* dst = static_cast<uint8_t*>(out);
    const auto* lut = static_cast<const uint8_t*>(table);
    const auto s = static_cast<cudaStream_t>(stream);
    const int a = aligned ? 16 : 1;  // n_vec and the grid were chosen by both addresses
    return static_cast<int>(
        lut != nullptr
            ? ipt::launch(elementwise_kernel<true>, static_cast<unsigned>(blocks), THREADS, 0, s,
                          {a, a}, src, dst, lut, n, n_vec)
            : ipt::launch(elementwise_kernel<false>, static_cast<unsigned>(blocks), THREADS, 0, s,
                          {a, a}, src, dst, nullptr, n, n_vec));
}
