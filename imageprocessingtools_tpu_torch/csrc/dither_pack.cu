// K10: print_ready's Bayer 4x4 dither and MSB-first P4 packing in one pass.
//
// Replaces no TPU kernel: the JAX package dithers and packs in jnp ops
// (imageprocessingtools_tpu/ops/dither.py, ops/packing.py), which XLA fuses
// on the TPU. The port ran those steps as ten torch launches inside
// print_ready's graph, each writing a whole int16, int32 or uint8 plane that
// the next read back: 204 us a 4K image, 89% of the task's device time. This
// kernel reads the equalized gray once and writes the packed rows once, and
// writes every byte of its output, so a graph's output can be bound to it.
//
// What it computes: gray uint8[N, H, W] -> out uint8[N, H, ceil(W / 8)].
// Pixel (y, x) is black (bit 1) where g < BAYER_THRESHOLD_INT[y % 4][x % 4]
// (ops/_exact.py: the C's double compare avg >= m * 255 of ppmx-edward.c:
// 949-971 as integer thresholds, each at most 255). print_ready dithers its
// gray as three equal channels, whose average (g + g + g) / 3 is g. Bit 7 - k
// of byte j of a row is pixel 8j + k (:268-284); a row's pad bits are 0.
//
// What bounds it on an H100: bytes. A 4K image is 8.29 MB in and 1.04 MB out,
// 2.79 us at 3.35 TB/s; the compare and the gather are about two integer
// operations a pixel.
//
// Design: a block takes a band of four rows of image blockIdx.y (one Bayer
// period, so row k of the band compares with threshold row k) and walks the
// image's bands grid-stride. Where the image's rows start on 16-byte
// boundaries (W % 16 == 0 and an aligned base) and its output rows on 2-byte
// ones, a thread loads 16 bytes of each of the band's four rows (four loads
// in flight), compares four bytes at a time with the row's threshold word in
// 32-bit integer arithmetic, gathers each eight results MSB-first with one
// multiply, and stores two output bytes a row. Otherwise a thread takes one
// output byte of each row and reads its up to eight pixels byte by byte; a
// pixel past the row's end reads as 255, which is below no threshold, so the
// pad bits are 0. No shared memory; the thresholds are a 16-byte argument.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BAND = 4;  // rows a block takes at a time: the Bayer period
constexpr uint32_t HIGH = 0x80808080u;

// Word k holds the thresholds of rows y % 4 == k, byte x % 4 that of column x.
struct Bayer {
    uint32_t row[BAND];
};

// Bit 7 of each byte: [the byte of w < the byte of t]; the other bits are
// left over. d's bit 7 is [w's low seven bits >= t's] (a byte's difference
// never borrows from the next), and the high bits decide where they differ.
__device__ __forceinline__ uint32_t below(uint32_t w, uint32_t t) {
    const uint32_t d = (w | HIGH) - (t & ~HIGH);
    return ~((w & ~t) | (~(w ^ t) & d));
}

// The P4 byte of eight pixels in bits 24-31: a holds pixels 0-3 (byte i is
// pixel i), b pixels 4-7. Pixel k's result goes to bit 8k + 4 (k < 4) or
// 8(k - 4) (k >= 4); the multiply adds it shifted by 27 - 9 (k % 4), which
// lands it on bit 31 - k. No two of the product's terms share a bit below 32,
// so nothing carries into the byte.
__device__ __forceinline__ uint32_t pack8(uint32_t a, uint32_t b, uint32_t t) {
    const uint32_t flags = ((below(a, t) >> 3) & 0x10101010u) |
                           ((below(b, t) >> 7) & 0x01010101u);
    return flags * 0x08040201u;
}

// Image blockIdx.y: gray + H W blockIdx.y, out + H ceil(W / 8) blockIdx.y.
__global__ void __launch_bounds__(THREADS)
dither_pack_kernel(const uint8_t* __restrict__ batch, uint8_t* __restrict__ batch_out,
                   Bayer bayer, int H, int W) {
    const long long row_bytes = (W + 7) / 8;
    const uint8_t* __restrict__ gray = batch + static_cast<long long>(H) * W * blockIdx.y;
    uint8_t* __restrict__ out = batch_out + H * row_bytes * blockIdx.y;
    const bool vec = W % 16 == 0 && reinterpret_cast<uintptr_t>(gray) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 2 == 0;
    const int bands = (H + BAND - 1) / BAND;
    for (int band = blockIdx.x; band < bands; band += gridDim.x) {
        const int rows = min(BAND, H - band * BAND);
        const uint8_t* src = gray + static_cast<long long>(band) * BAND * W;
        uint8_t* dst = out + static_cast<long long>(band) * BAND * row_bytes;
        if (vec) {
            const int words = W / 16;
            for (int c = threadIdx.x; c < words; c += THREADS) {
                uint4 v[BAND];
#pragma unroll
                for (int k = 0; k < BAND; ++k) {
                    if (k < rows) v[k] = __ldg(reinterpret_cast<const uint4*>(src + k * static_cast<long long>(W)) + c);
                }
#pragma unroll
                for (int k = 0; k < BAND; ++k) {
                    if (k < rows) {
                        const uint32_t t = bayer.row[k];
                        // bytes 0 and 1: the top bytes of the two products
                        reinterpret_cast<uint16_t*>(dst + k * row_bytes)[c] = static_cast<uint16_t>(
                            __byte_perm(pack8(v[k].x, v[k].y, t), pack8(v[k].z, v[k].w, t), 0x73));
                    }
                }
            }
        } else {
            for (long long j = threadIdx.x; j < row_bytes; j += THREADS) {
                const int n = static_cast<int>(min(8LL, W - 8 * j));
                for (int k = 0; k < rows; ++k) {
                    const uint8_t* p = src + k * static_cast<long long>(W) + 8 * j;
                    uint32_t a = 0xFFFFFFFFu, b = 0xFFFFFFFFu;
#pragma unroll
                    for (int i = 0; i < 8; ++i) {
                        if (i < n) {
                            uint32_t& w = i < 4 ? a : b;
                            const int shift = 8 * (i % 4);
                            w = (w & ~(0xFFu << shift)) | (static_cast<uint32_t>(p[i]) << shift);
                        }
                    }
                    dst[k * row_bytes + j] = static_cast<uint8_t>(pack8(a, b, bayer.row[k]) >> 24);
                }
            }
        }
    }
}

}  // namespace

// gray uint8[N, H, W] -> out uint8[N, H, ceil(W / 8)] in one launch: a block
// a band of four rows, at most 65535 a row of the grid (a grid-stride loop
// takes the rest). t0-t3: the rows of the threshold matrix, byte x % 4 of
// word y % 4. The kernel picks its loads by the image's addresses itself.
extern "C" int ipt_dither_pack_batch(const void* gray, void* out, int N, int H, int W,
                                     unsigned int t0, unsigned int t1, unsigned int t2,
                                     unsigned int t3, int device, void* stream) {
    if (N < 1 || N > 65535 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    long long blocks = (H + BAND - 1LL) / BAND;
    if (blocks > 65535) blocks = 65535;
    return static_cast<int>(ipt::launch(
        dither_pack_kernel, dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(N)),
        THREADS, 0, static_cast<cudaStream_t>(stream), {}, static_cast<const uint8_t*>(gray),
        static_cast<uint8_t*>(out), Bayer{{t0, t1, t2, t3}}, H, W));
}
