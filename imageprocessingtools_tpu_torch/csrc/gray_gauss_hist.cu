// K2: grayscale -> 5x5 binomial Gaussian -> 256-bin histogram, in one pass,
// and K6: the same without the histogram (grayscale fused into the Gaussian).
//
// Replaces the Pallas kernels
//   imageprocessingtools_tpu/kernels/pallas_core.py::gray_gauss_hist_pallas
// (body _gray_gauss_hist_kernel, launch _gray_gauss_hist_call) and
//   imageprocessingtools_tpu/kernels/pallas_core.py::gray_gauss_pallas
// (body _gray_gauss_kernel). The TPU forms walked row slabs over planar RGB
// with neighbouring-slab halo blocks; K2's also padded lanes to 128, carried
// the histogram across sequential grid steps, built it from nibble one-hot
// matmuls and needed H >= 8 (K6 was its fallback below that). Here both are
// one tile kernel, instantiated with and without the histogram:
//
// - one block per 32x128 output tile; the block loads RGB for the tile plus
//   a 2-pixel halo with clamped coordinates (replicate edges), and keeps the
//   gray values (r+g+b)/3 in shared memory;
// - the separable 1-4-6-4-1 runs in int32 out of shared memory (vertical,
//   then horizontal; gauss5.cuh, shared with K5), then (acc+128)>>8 to
//   uint8 — integer-exact, so the result is the same bytes as
//   ops/stencil.py::gaussian_blur;
// - K2 only: a block-private int[256] histogram in shared memory counts
//   the tile's blurred bytes with shared atomics and is flushed with one
//   global atomicAdd per non-empty bin into an int32[256] the wrapper
//   zeroes. Integer sums are order-free, so the histogram is exact.
//
// Any H >= 1 and W >= 1 is valid: no slab, no lane padding, no fallback.
//
// What bounds both on an H100: bytes (3 bytes read and 1 written per pixel:
// 24.9 MB in and 8.3 MB out at 4K, plus the halo re-reads of ~16%). The
// byte-wise RGB loads are not vectorised in this first version. For K2 on
// real photos, shared-atomic contention on a few hot bins is the likely limit.

#include <cstdint>
#include <cuda_runtime.h>

#include "gauss5.cuh"

namespace {

using ipt::GAUSS_HALO_H;
using ipt::GAUSS_HALO_W;
using ipt::GAUSS_RADIUS;
using ipt::GAUSS_TILE_H;
using ipt::GAUSS_TILE_W;

constexpr int THREADS = 256;

template <bool kHistogram>
__global__ void __launch_bounds__(THREADS)
gray_gauss_kernel(const uint8_t* __restrict__ rgb, uint8_t* __restrict__ out,
                  int* __restrict__ hist, int H, int W) {
    __shared__ int gray[GAUSS_HALO_H][GAUSS_HALO_W];
    __shared__ int vsum[GAUSS_TILE_H][GAUSS_HALO_W];
    __shared__ int shist[kHistogram ? 256 : 1];

    const int tid = threadIdx.x;
    const int x0 = blockIdx.x * GAUSS_TILE_W;
    const int y0 = blockIdx.y * GAUSS_TILE_H;
    if constexpr (kHistogram) {
        for (int b = tid; b < 256; b += THREADS) shist[b] = 0;
    }

    for (int k = tid; k < GAUSS_HALO_H * GAUSS_HALO_W; k += THREADS) {
        const int r = k / GAUSS_HALO_W;
        const int c = k - r * GAUSS_HALO_W;
        const int gy = min(max(y0 + r - GAUSS_RADIUS, 0), H - 1);
        const int gx = min(max(x0 + c - GAUSS_RADIUS, 0), W - 1);
        const uint8_t* p = rgb + (static_cast<size_t>(gy) * W + gx) * 3;
        gray[r][c] = (static_cast<int>(__ldg(p)) + __ldg(p + 1) + __ldg(p + 2)) / 3;
    }
    __syncthreads();

    ipt::gauss5_tile<THREADS>(gray, vsum, y0, x0, H, W, [&](int y, int x, int val) {
        out[static_cast<size_t>(y) * W + x] = static_cast<uint8_t>(val);
        if constexpr (kHistogram) atomicAdd(&shist[val], 1);
    });

    if constexpr (kHistogram) {
        __syncthreads();
        for (int b = tid; b < 256; b += THREADS) {
            if (shist[b]) atomicAdd(&hist[b], shist[b]);
        }
    }
}

template <bool kHistogram>
int launch(const void* rgb, void* out, void* hist, int H, int W, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((W + GAUSS_TILE_W - 1) / GAUSS_TILE_W, (H + GAUSS_TILE_H - 1) / GAUSS_TILE_H);
    gray_gauss_kernel<kHistogram><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(rgb), static_cast<uint8_t*>(out),
        static_cast<int*>(hist), H, W);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2: rgb uint8[H, W, 3] -> out uint8[H, W] and hist int32[256] (zeroed by
// the caller).
extern "C" int ipt_gray_gauss_hist(const void* rgb, void* out, void* hist, int H, int W,
                                   int device, void* stream) {
    return launch<true>(rgb, out, hist, H, W, device, stream);
}

// K6: rgb uint8[H, W, 3] -> out uint8[H, W].
extern "C" int ipt_gray_gauss(const void* rgb, void* out, int H, int W, int device,
                              void* stream) {
    return launch<false>(rgb, out, nullptr, H, W, device, stream);
}
