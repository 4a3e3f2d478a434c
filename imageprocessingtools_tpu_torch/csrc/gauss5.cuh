// The separable 5x5 binomial (1,4,6,4,1)^2 over a shared-memory tile with a
// 2-pixel halo, shared by K2 and K6 (gray_gauss_hist.cu) and K5 (stencil.cu).
//
// The caller loads the tile's gray values plus the halo, with coordinates
// clamped into the image (replicate edges), into `gray`, and synchronises.
// The vertical pass sums into `vsum` in int32; the horizontal pass rounds
// with (acc + 128) >> 8 and hands each in-image output pixel to `emit`.
// Integer-exact, so the bytes equal ops/stencil.py::gaussian_blur's.

#pragma once

namespace ipt {

constexpr int GAUSS_TILE_H = 32;
constexpr int GAUSS_TILE_W = 128;
constexpr int GAUSS_RADIUS = 2;
constexpr int GAUSS_HALO_H = GAUSS_TILE_H + 2 * GAUSS_RADIUS;
constexpr int GAUSS_HALO_W = GAUSS_TILE_W + 2 * GAUSS_RADIUS;

// emit(y, x, value) for every output pixel of the tile at (y0, x0) that
// lies inside the H x W image.
template <int THREADS, class Emit>
__device__ __forceinline__ void gauss5_tile(const int (*gray)[GAUSS_HALO_W],
                                            int (*vsum)[GAUSS_HALO_W], int y0, int x0,
                                            int H, int W, Emit emit) {
    for (int k = threadIdx.x; k < GAUSS_TILE_H * GAUSS_HALO_W; k += THREADS) {
        const int r = k / GAUSS_HALO_W;
        const int c = k - r * GAUSS_HALO_W;
        vsum[r][c] = gray[r][c] + 4 * gray[r + 1][c] + 6 * gray[r + 2][c] +
                     4 * gray[r + 3][c] + gray[r + 4][c];
    }
    __syncthreads();

    for (int k = threadIdx.x; k < GAUSS_TILE_H * GAUSS_TILE_W; k += THREADS) {
        const int r = k / GAUSS_TILE_W;
        const int c = k - r * GAUSS_TILE_W;
        const int y = y0 + r;
        const int x = x0 + c;
        if (y < H && x < W) {
            const int* v = &vsum[r][c];
            const int acc = v[0] + 4 * v[1] + 6 * v[2] + 4 * v[3] + v[4];
            emit(y, x, (acc + 128) >> 8);
        }
    }
}

}  // namespace ipt
