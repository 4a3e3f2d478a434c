// K5 and K7: the gray stencils with replicate edges, uint8[H, W] -> uint8[H, W].
//
// K5 replaces the Pallas kernel
//   imageprocessingtools_tpu/kernels/pallas_core.py::gaussian_blur_pallas
// (body _gauss5_kernel): the 5x5 binomial (1,4,6,4,1)^2, (acc+128)>>8.
// K7 replaces _make_stencil3 (body _stencil3_kernel) and its three instances
// box_blur_pallas, sharpen_pallas and sobel_pallas: 3x3 integer stencils.
//
// The TPU kernels walked row blocks over the whole width and fetched the
// neighbouring blocks for a row halo, padded the columns inside the kernel,
// and needed the rows padded to a block multiple outside it. Here one block
// owns a 32x128 output tile and loads the tile plus its halo (radius 2 for
// K5, 1 for K7) into shared memory with clamped coordinates, which gives
// replicate edges at any H >= 1 and W >= 1 with no padding. Arithmetic is
// int32:
//
// - K5 runs the separable passes of gauss5.cuh, shared with K2;
// - K7 is one template over the 3x3 weights and an epilogue:
//   box (2s+9)/18 (s >= 0, so the division is the floor); sharpen
//   [0,-1,0; -1,5,-1; 0,-1,0] clipped to [0, 255]; Sobel
//   clip(round_half_up(sqrt(gx^2 + gy^2)), 0, 255). Sobel's root is exact:
//   m = gx^2 + gy^2 <= 2,080,800 is exact in f32, __fsqrt_rn gives the
//   correctly rounded root, floor(x + 0.5) an estimate k within 1 of the
//   answer, and the two integer corrections of ops/stencil.py::_isqrt_round
//   (k^2 - k + 1 <= m <= k^2 + k) make it exact. No --use_fast_math.
//
// What bounds them on an H100: bytes (1 read and 1 written per pixel, 8.3 MB
// each way at 4K, plus halo re-reads of ~16% for K5 and ~8% for K7). The
// byte-wise loads and stores are not vectorised in this first version.

#include <cstdint>
#include <cuda_runtime.h>

#include "gauss5.cuh"

namespace {

constexpr int THREADS = 256;

// ---- K5 -------------------------------------------------------------------

using ipt::GAUSS_HALO_H;
using ipt::GAUSS_HALO_W;
using ipt::GAUSS_RADIUS;
using ipt::GAUSS_TILE_H;
using ipt::GAUSS_TILE_W;

__global__ void __launch_bounds__(THREADS)
gaussian_blur_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out, int H, int W) {
    __shared__ int gray[GAUSS_HALO_H][GAUSS_HALO_W];
    __shared__ int vsum[GAUSS_TILE_H][GAUSS_HALO_W];

    const int x0 = blockIdx.x * GAUSS_TILE_W;
    const int y0 = blockIdx.y * GAUSS_TILE_H;
    for (int k = threadIdx.x; k < GAUSS_HALO_H * GAUSS_HALO_W; k += THREADS) {
        const int r = k / GAUSS_HALO_W;
        const int c = k - r * GAUSS_HALO_W;
        const int gy = min(max(y0 + r - GAUSS_RADIUS, 0), H - 1);
        const int gx = min(max(x0 + c - GAUSS_RADIUS, 0), W - 1);
        gray[r][c] = __ldg(src + static_cast<size_t>(gy) * W + gx);
    }
    __syncthreads();

    ipt::gauss5_tile<THREADS>(gray, vsum, y0, x0, H, W, [&](int y, int x, int val) {
        out[static_cast<size_t>(y) * W + x] = static_cast<uint8_t>(val);
    });
}

// ---- K7 -------------------------------------------------------------------

constexpr int S_TILE_H = 32;
constexpr int S_TILE_W = 128;
constexpr int S_HALO_H = S_TILE_H + 2;
constexpr int S_HALO_W = S_TILE_W + 2;

// Each op: kSets weight sets w(set, dy, dx) over the 3x3 window, and an
// epilogue from the kSets sums to the output value in [0, 255].
struct BoxBlur {
    static constexpr int kSets = 1;
    __host__ __device__ static constexpr int w(int, int, int) { return 1; }
    __device__ static int epilogue(const int* s) { return (2 * s[0] + 9) / 18; }
};

struct Sharpen {
    static constexpr int kSets = 1;
    __host__ __device__ static constexpr int w(int, int dy, int dx) {
        return (dy == 1 && dx == 1) ? 5 : ((dy == 1 || dx == 1) ? -1 : 0);
    }
    __device__ static int epilogue(const int* s) { return min(max(s[0], 0), 255); }
};

// round_half_up(sqrt(m)) for 0 <= m < 2^24, exact (see the header note).
__device__ __forceinline__ int isqrt_round(int m) {
    int k = static_cast<int>(floorf(__fadd_rn(__fsqrt_rn(static_cast<float>(m)), 0.5f)));
    if (m > k * k + k) k += 1;
    if (k > 0 && m < k * k - k + 1) k -= 1;
    return k;
}

struct Sobel {
    static constexpr int kSets = 2;
    // set 0: gx = [-1,0,1; -2,0,2; -1,0,1]; set 1: gy = [-1,-2,-1; 0,0,0; 1,2,1]
    __host__ __device__ static constexpr int w(int set, int dy, int dx) {
        return set == 0 ? (dx - 1) * (dy == 1 ? 2 : 1) : (dy - 1) * (dx == 1 ? 2 : 1);
    }
    __device__ static int epilogue(const int* s) {
        return min(isqrt_round(s[0] * s[0] + s[1] * s[1]), 255);
    }
};

template <class Op>
__global__ void __launch_bounds__(THREADS)
stencil3_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out, int H, int W) {
    __shared__ int tile[S_HALO_H][S_HALO_W];

    const int x0 = blockIdx.x * S_TILE_W;
    const int y0 = blockIdx.y * S_TILE_H;
    for (int k = threadIdx.x; k < S_HALO_H * S_HALO_W; k += THREADS) {
        const int r = k / S_HALO_W;
        const int c = k - r * S_HALO_W;
        const int gy = min(max(y0 + r - 1, 0), H - 1);
        const int gx = min(max(x0 + c - 1, 0), W - 1);
        tile[r][c] = __ldg(src + static_cast<size_t>(gy) * W + gx);
    }
    __syncthreads();

    for (int k = threadIdx.x; k < S_TILE_H * S_TILE_W; k += THREADS) {
        const int r = k / S_TILE_W;
        const int c = k - r * S_TILE_W;
        const int y = y0 + r;
        const int x = x0 + c;
        if (y < H && x < W) {
            int sums[Op::kSets];
#pragma unroll
            for (int s = 0; s < Op::kSets; ++s) {
                int acc = 0;
#pragma unroll
                for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
                    for (int dx = 0; dx < 3; ++dx) {
                        acc += Op::w(s, dy, dx) * tile[r + dy][c + dx];
                    }
                }
                sums[s] = acc;
            }
            out[static_cast<size_t>(y) * W + x] = static_cast<uint8_t>(Op::epilogue(sums));
        }
    }
}

template <class Op>
int launch_stencil3(const void* src, void* out, int H, int W, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((W + S_TILE_W - 1) / S_TILE_W, (H + S_TILE_H - 1) / S_TILE_H);
    stencil3_kernel<Op><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(src), static_cast<uint8_t*>(out), H, W);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ipt_gaussian_blur(const void* src, void* out, int H, int W, int device,
                                 void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((W + GAUSS_TILE_W - 1) / GAUSS_TILE_W, (H + GAUSS_TILE_H - 1) / GAUSS_TILE_H);
    gaussian_blur_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(src), static_cast<uint8_t*>(out), H, W);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int ipt_box_blur(const void* src, void* out, int H, int W, int device,
                            void* stream) {
    return launch_stencil3<BoxBlur>(src, out, H, W, device, stream);
}

extern "C" int ipt_sharpen(const void* src, void* out, int H, int W, int device,
                           void* stream) {
    return launch_stencil3<Sharpen>(src, out, H, W, device, stream);
}

extern "C" int ipt_sobel(const void* src, void* out, int H, int W, int device,
                         void* stream) {
    return launch_stencil3<Sobel>(src, out, H, W, device, stream);
}
