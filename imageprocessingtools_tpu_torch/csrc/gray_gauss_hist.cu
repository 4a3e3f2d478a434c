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
// one tile kernel, instantiated with and without the histogram, for any
// H >= 1 and W >= 1: no slab, no lane padding, no fallback.
//
// What bounds both on an H100: bytes. A 4K frame reads 24.9 MB of RGB and
// writes 8.3 MB of gray, 9.9 us at 3.35 TB/s. The integer work comes close:
// ~20 operations per pixel take 2.5 us at the f32 rate that chip_smoke.py's
// bound uses, but integer instructions issue at about a quarter of that
// (64 lanes per SM, 16.7 T op/s), so ~20 instructions per pixel would take
// as long as the bytes. The design keeps the instructions per pixel low and
// runs them while the next tile's bytes arrive:
//
// - Tiles of 256x16 outputs. A block of 4 warps stays resident and takes
//   tiles blockIdx.x, + gridDim.x, ... (as many blocks as fit on the card);
//   it stages the next tile's 20 halo rows (clamped at the top and bottom)
//   in one of two shared buffers while it computes the current tile.
// - Staging: the 16-byte chunks of a halo row that lie inside the image go
//   in one bulk copy (cp.async.bulk on the copy engine, completing on an
//   mbarrier; bulk_copy.cuh), one thread per row. A row that does not start
//   on a 16-byte boundary sits at its own offset ("lead"). The bytes inside
//   the image of the chunks that straddle its left or right edge are copied
//   one by one; nothing outside the image is read, and the edge columns'
//   gray values are replicated instead. Nothing is widened to int.
// - Gray and the horizontal pass: a warp takes a halo row, a lane 8 of its
//   columns. r + g + b by dp4a, s / 3 as (s * 0x55555556) >> 32 (exact for
//   every s < 2^31), the gray in the 16-bit halves of registers (even and
//   odd columns apart), each lane's halo columns from its neighbours
//   (shuffles), and the horizontal 1-4-6-4-1 sums of its 8 columns, two to a
//   register (at most 16 * 255 = 4080 each). They go back into the buffer
//   that held the tile's RGB.
// - The vertical pass: a thread makes 8 columns of 4 rows from 8 rows of
//   those sums, adding five rows and 128 in the same halves (at most 65,408
//   < 2^16, so no carry crosses a half); each half's upper byte is its
//   rounded output, (acc + 128) >> 8. No division, no per-element index. A
//   run of 8 goes out as one 8-byte store where the row allows it, else in
//   aligned pieces, or bytes at the ragged edge.
//
// K2 only: a block-private int[256] histogram in shared memory counts the
// blurred bytes of all the block's tiles, one shared atomic per pixel, except
// that a run of 8 equal bytes (a flat region, a constant image) is counted by
// one atomic; it is flushed with one global atomicAdd per non-empty bin into
// an int32[256] the wrapper zeroes. Integer sums are order-free, so the
// histogram is exact, and the bytes equal core.gray_gauss_plain's.
//
// The batch axis (the counterpart of jax.vmap of the Pallas kernels, whose
// batching rule adds a leading grid axis): uint8[N, H, W, 3] -> uint8[N, H,
// W] (and int32[N, 256]) in one launch. The tiles of all N images are one
// index, t = n * tiles_per_image + the tile's index in image n, so the
// resident blocks fill the card at any image size (a 512x512 image has 64
// tiles for 132 SMs). A block walks tiles of several images; its shared
// histogram is flushed into hist[n] (and zeroed) whenever its next tile lies
// in another image or it has none, so counts never mix images. A single
// image is the batch of one. Image n starts at byte 3 H W n of rgb and H W n
// of out; with W % 16 == 0 every image's start keeps the alignment of the
// first, so kAligned holds for all of them when it holds for the first.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"
#include "gauss_tile.cuh"
#include "launch.cuh"

namespace {

using ipt::RUN;                                   // outputs per thread per row
using ipt::clamp_right;
using ipt::hsum8;
using ipt::load_words;
using ipt::store_run;
using ipt::vsum8;
constexpr int TILE_W = 32 * RUN;                  // a warp spans the tile's width
constexpr int TY = 4;                             // warps
constexpr int TILE_H = 16;
constexpr int ROWS = TILE_H / TY;                 // output rows per thread
constexpr int HALO_H = TILE_H + 4;
constexpr int THREADS = 32 * TY;
constexpr int RGB_CHUNKS = 3 * TILE_W / 16 + 3;   // 16-byte chunks per staged RGB row
constexpr int RGB_STRIDE = 16 * RGB_CHUNKS;
static_assert(HALO_H % TY == 0 && 2 * TILE_W <= RGB_STRIDE, "h_s rows fit in staged rows");

// floor(s / 3) for 0 <= s < 2^31.
__device__ __forceinline__ uint32_t div3(uint32_t s) { return __umulhi(s, 0x55555556u); }

// Gray of the four pixels c .. c + 3 whose RGB bytes are the words a, b, c,
// in the 16-bit halves of two registers: e = (c, c + 2), o = (c + 1, c + 3).
__device__ __forceinline__ void gray4(uint32_t a, uint32_t b, uint32_t c, uint32_t& e,
                                      uint32_t& o) {
    const uint32_t g0 = div3(__dp4a(a, 0x00010101u, 0u));
    const uint32_t g1 = div3(__dp4a(b, 0x00000101u, __dp4a(a, 0x01000000u, 0u)));
    const uint32_t g2 = div3(__dp4a(c, 0x00000001u, __dp4a(b, 0x01010000u, 0u)));
    const uint32_t g3 = div3(__dp4a(c, 0x01010100u, 0u));
    e = __byte_perm(g0, g2, 0x5410);
    o = __byte_perm(g1, g3, 0x5410);
}

// Dynamic shared memory: two staging buffers, their mbarriers, the histogram.
constexpr int BUF_BYTES = HALO_H * RGB_STRIDE;
constexpr int SMEM_BYTES = 2 * BUF_BYTES + 2 * 8 + 256 * 4;

// kAligned: rgb and W are multiples of 16 and out of 8, so every staged row
// starts on a 16-byte boundary (lead 0) and every run stores 8 bytes.
//
// A block stays resident and takes tiles blockIdx.x, + gridDim.x, ...; it
// stages tile i + 1 in one buffer while it computes tile i from the other.
// Tile t is tile t % per_image of image t / per_image; tiles = N per_image.
template <bool kHistogram, bool kAligned>
__global__ void __launch_bounds__(THREADS)
gray_gauss_kernel(const uint8_t* __restrict__ rgb, uint8_t* __restrict__ out,
                  int* __restrict__ hist, int H, int W, int tiles_x, int per_image,
                  int tiles) {
    // buf[k] row r: image row clamp(y0 - 2 + r), from row byte 3 x0 - 16 - lead
    // on. Once step 2 has read it, the same memory holds h_s: row r, word
    // 4 l + m, the horizontal sums h[m] of columns x0 + 8 l .. + 7 (hsum8).
    extern __shared__ __align__(16) uint8_t smem[];
    auto buf = reinterpret_cast<uint8_t (*)[HALO_H][RGB_STRIDE]>(smem);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * BUF_BYTES);  // one mbarrier per buffer
    int* shist = reinterpret_cast<int*>(full + 2);

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int W3 = 3 * W;
    if (tid == 0) {
        ipt::mbar_init(&full[0], HALO_H);
        ipt::mbar_init(&full[1], HALO_H);
    }
    if constexpr (kHistogram) {
        for (int b = tid; b < 256; b += THREADS) shist[b] = 0;
    }
    __syncthreads();
    // Image n's RGB (its output is at out + n H W), and halo row r of a tile
    // at row y0 of an image that starts at img.
    auto image_rgb = [&](int n) { return rgb + static_cast<size_t>(n) * H * W3; };
    auto halo_row = [&](const uint8_t* img, int y0, int r) {
        return img + static_cast<size_t>(min(max(y0 + r - 2, 0), H - 1)) * W3;
    };
    // Row byte of a staged row's first byte: 16-byte aligned in memory (3 x0
    // is a multiple of 16).
    auto base_of = [&](int x0, const uint8_t* row) {
        return 3 * x0 - 16 - (kAligned ? 0 : static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15));
    };

    // 1. Load tile t into buf[k]: thread r < HALO_H copies row r's chunks that
    // lie inside the image in one bulk copy, and the bytes inside the image of
    // the (at most two) chunks that straddle its left or right edge one by
    // one. Bytes outside the image are not read: step 2 replicates the edge
    // columns' gray values instead.
    // A tile is (n, local): tile local of image n.
    auto load = [&](int n, int local, int k) {
        if (tid >= HALO_H) return;
        const int x0 = (local % tiles_x) * TILE_W, y0 = (local / tiles_x) * TILE_H;
        const uint8_t* row = halo_row(image_rgb(n), y0, tid);
        ipt::stage_row<RGB_CHUNKS>(buf[k][tid], row, base_of(x0, row), W3, &full[k]);
    };

    const int first = blockIdx.x, step = gridDim.x;  // the launch makes first < tiles
    // The block's next tile is step tiles on: step divided by per_image once
    // here, so that a tile costs the single image's index arithmetic.
    const int step_n = step / per_image, step_local = step % per_image;
    int n = first / per_image, local = first % per_image;
    load(n, local, 0);
    __syncthreads();  // the first tile's edge bytes (later tiles': the loop's barriers)
    for (int t = first, i = 0; t < tiles; t += step, ++i) {
        const int k = i & 1;
        int next_n = n + step_n, next_local = local + step_local;
        if (next_local >= per_image) {
            next_local -= per_image;
            ++next_n;
        }
        if (t + step < tiles) load(next_n, next_local, k ^ 1);
        const int x0 = (local % tiles_x) * TILE_W, y0 = (local / tiles_x) * TILE_H;
        const uint8_t* img = image_rgb(n);
        uint8_t* img_out = out + static_cast<size_t>(n) * H * W;
        ipt::mbar_wait(&full[k], (i >> 1) & 1);

        // 2. Gray and the horizontal pass: warp w takes halo rows w, w + TY,
        // ...; lane l the 8 columns x0 + 8 l .. + 7 (RGB at byte 24 l + 16 +
        // lead), and the two halo columns beyond the tile's edge, x0 - 2 and
        // x0 - 1 for lane 0 (RGB at byte 10 + lead) and x0 + TILE_W and + 1
        // for the others (byte 3 TILE_W + 16 + lead), which lanes 0 and 31
        // need; the rest of each lane's halo comes from its neighbours. In
        // the tiles at the image's left or right edge, columns left of 0 take
        // column 0's gray and columns from W on take column W - 1's.
        const bool at_edge = x0 == 0 || x0 + TILE_W + 2 > W;
        uint32_t hreg[HALO_H / TY][4];
#pragma unroll
        for (int j = 0; j < HALO_H / TY; ++j) {
            const int r = warp + TY * j;
            const uint8_t* row_s = buf[k][r] + 16 + (3 * x0 - 16 - base_of(x0, halo_row(img, y0, r)));  // column x0
            uint32_t w[6], u[2];
            load_words<kAligned, 6>(row_s + 24 * lane, w);
            load_words<kAligned, 2>(row_s + (lane == 0 ? -8 : 3 * TILE_W), u);
            uint32_t ea, oa, eb, ob;
            gray4(w[0], w[1], w[2], ea, oa);
            gray4(w[3], w[4], w[5], eb, ob);
            // The two halo columns: in the high halves for lane 0, else the low.
            uint32_t ee = div3(__dp4a(u[1], lane == 0 ? 0x00000001u : 0u,
                                      __dp4a(u[0], lane == 0 ? 0x01010000u : 0x00010101u, 0u)))
                          << (lane == 0 ? 16 : 0);
            uint32_t oe = div3(__dp4a(u[1], lane == 0 ? 0x01010100u : 0x00000101u,
                                      __dp4a(u[0], lane == 0 ? 0u : 0x01000000u, 0u)))
                          << (lane == 0 ? 16 : 0);
            if (at_edge) {
                const int c = min(W - 1 - x0, TILE_W + 1);  // the last column that counts
                const uint8_t* p = row_s + 3 * c;
                const uint32_t last = div3(p[0] + p[1] + p[2]);
                const int cols = W - x0 - RUN * lane;
                clamp_right(ea, oa, cols, last);
                clamp_right(eb, ob, cols - 4, last);
                clamp_right(ee, oe, lane == 0 ? 4 : W - x0 - TILE_W, last);  // lane 0's lie left
                if (x0 == 0 && lane == 0) ee = oe = ea << 16;  // column 0's gray
            }
            uint32_t el = __shfl_up_sync(0xFFFFFFFFu, eb, 1), ol = __shfl_up_sync(0xFFFFFFFFu, ob, 1);
            uint32_t er = __shfl_down_sync(0xFFFFFFFFu, ea, 1), orr = __shfl_down_sync(0xFFFFFFFFu, oa, 1);
            if (lane == 0) el = ee, ol = oe;
            if (lane == 31) er = ee, orr = oe;
            hsum8(el, ol, ea, oa, eb, ob, er, orr, hreg[j]);
        }
        __syncthreads();  // every read of buf[k] is done: its memory takes h_s
        auto h_s = reinterpret_cast<uint32_t (*)[TILE_W / 2]>(buf[k]);
#pragma unroll
        for (int j = 0; j < HALO_H / TY; ++j) {
            *reinterpret_cast<uint4*>(&h_s[warp + TY * j][4 * lane]) =
                make_uint4(hreg[j][0], hreg[j][1], hreg[j][2], hreg[j][3]);
        }
        __syncthreads();

        // 3. The vertical pass: lane l, warp w makes columns x .. x + 7 of
        // output rows y0 + ROWS w .. + ROWS - 1 from h_s rows ROWS w .. ROWS w
        // + ROWS + 3.
        const int x = x0 + RUN * lane;
        if (x < W) {
            const int r0 = ROWS * warp;
            uint32_t h[ROWS + 4][4];
#pragma unroll
            for (int j = 0; j < ROWS + 4; ++j) {
                const uint4 q = *reinterpret_cast<const uint4*>(&h_s[r0 + j][4 * lane]);
                h[j][0] = q.x;
                h[j][1] = q.y;
                h[j][2] = q.z;
                h[j][3] = q.w;
            }
            const int len = min(RUN, W - x);
#pragma unroll
            for (int j = 0; j < ROWS; ++j) {
                const int y = y0 + r0 + j;
                if (y >= H) break;
                uint32_t lo, hi;
                vsum8(h[j], h[j + 1], h[j + 2], h[j + 3], h[j + 4], lo, hi);
                store_run<kAligned>(img_out + static_cast<size_t>(y) * W + x, lo, hi, len);
                if constexpr (kHistogram) {
                    if (len == RUN && lo == hi && lo == __byte_perm(lo, 0, 0)) {
                        atomicAdd(&shist[lo & 0xFF], RUN);
                    } else {
#pragma unroll
                        for (int q = 0; q < RUN; ++q) {
                            if (q < len) atomicAdd(&shist[((q < 4 ? lo : hi) >> (8 * (q & 3))) & 0xFF], 1);
                        }
                    }
                }
            }
        }
        __syncthreads();  // step 3's reads of buf[k] are done before it is loaded again

        // 4. Flush the counts into image n's histogram before a tile of
        // another image is counted (the next atomics on shist come after the
        // next tile's two barriers).
        if constexpr (kHistogram) {
            if (t + step >= tiles || next_n != n) {
                int* h = hist + 256 * static_cast<size_t>(n);
                for (int b = tid; b < 256; b += THREADS) {
                    if (shist[b]) {
                        atomicAdd(&h[b], shist[b]);
                        shist[b] = 0;
                    }
                }
            }
        }
        n = next_n;
        local = next_local;
    }
}

template <bool kHistogram, bool kAligned>
int launch_kernel(const uint8_t* rgb, uint8_t* out, int* hist, int N, int H, int W, int device,
                  cudaStream_t stream) {
    const auto kernel = gray_gauss_kernel<kHistogram, kAligned>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_BYTES);
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, SMEM_BYTES);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles_x = (W + TILE_W - 1) / TILE_W;
    const long long per_image = static_cast<long long>(tiles_x) * ((H + TILE_H - 1) / TILE_H);
    const long long tiles = N * per_image;  // the wrapper keeps it below 2^31
    if (N < 1 || tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const long long resident = static_cast<long long>(max(per_sm, 1)) * sms;
    const int grid = static_cast<int>(tiles < resident ? tiles : resident);
    // The aligned instance was chosen by rgb's 16 bytes and out's 8.
    return static_cast<int>(ipt::launch(kernel, grid, THREADS, SMEM_BYTES, stream,
                                        {kAligned ? 16 : 1, kAligned ? 8 : 1}, rgb, out, hist, H,
                                        W, tiles_x, static_cast<int>(per_image),
                                        static_cast<int>(tiles)));
}

template <bool kHistogram>
int launch(const void* rgb, void* out, void* hist, int N, int H, int W, int device,
           void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool aligned = ((reinterpret_cast<uintptr_t>(rgb) | static_cast<uintptr_t>(W)) & 15) == 0 &&
                         (reinterpret_cast<uintptr_t>(out) & 7) == 0;
    const auto* in = static_cast<const uint8_t*>(rgb);
    auto* o = static_cast<uint8_t*>(out);
    auto* h = static_cast<int*>(hist);
    const auto s = static_cast<cudaStream_t>(stream);
    return aligned ? launch_kernel<kHistogram, true>(in, o, h, N, H, W, device, s)
                   : launch_kernel<kHistogram, false>(in, o, h, N, H, W, device, s);
}

}  // namespace

// K2: rgb uint8[H, W, 3] -> out uint8[H, W] and hist int32[256] (zeroed by
// the caller).
extern "C" int ipt_gray_gauss_hist(const void* rgb, void* out, void* hist, int H, int W,
                                   int device, void* stream) {
    return launch<true>(rgb, out, hist, 1, H, W, device, stream);
}

// K6: rgb uint8[H, W, 3] -> out uint8[H, W].
extern "C" int ipt_gray_gauss(const void* rgb, void* out, int H, int W, int device,
                              void* stream) {
    return launch<false>(rgb, out, nullptr, 1, H, W, device, stream);
}

// K2 over a batch: rgb uint8[N, H, W, 3] -> out uint8[N, H, W] and hist
// int32[N, 256] (zeroed by the caller), in one launch.
extern "C" int ipt_gray_gauss_hist_batch(const void* rgb, void* out, void* hist, int N, int H,
                                         int W, int device, void* stream) {
    return launch<true>(rgb, out, hist, N, H, W, device, stream);
}

// K6 over a batch: rgb uint8[N, H, W, 3] -> out uint8[N, H, W], in one launch.
extern "C" int ipt_gray_gauss_batch(const void* rgb, void* out, int N, int H, int W, int device,
                                    void* stream) {
    return launch<false>(rgb, out, nullptr, N, H, W, device, stream);
}
