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
// and needed the rows padded to a block multiple outside it. Here each block
// stages its output tile plus the halo (radius 2 for K5, 1 for K7) in shared
// memory as the image's own bytes, which gives replicate edges at any H >= 1
// and W >= 1 with no padding. Arithmetic is integer and exact:
//
// - K5 is K2/K6's tile (gray_gauss_hist.cu) without its gray step: resident
//   4-warp blocks walk 256x16 output tiles and stage the next tile's 20 halo
//   rows (clamped at the top and bottom; one bulk copy per row on an
//   mbarrier, bulk_copy.cuh) in one of two buffers while they compute the
//   current one. A lane takes 8 columns of a row: it unpacks the 16 bytes
//   around them into even and odd columns in 16-bit halves (two byte
//   permutes a word), replicates the edge columns in those halves where the
//   tile meets the image's left or right edge, and makes the horizontal
//   1-4-6-4-1 sums two to a register; the vertical pass adds five rows of
//   them in the same halves and stores 8 bytes (gauss_tile.cuh, shared with
//   K2/K6). With one byte per pixel the sums (512 bytes a row) do not fit
//   over the staged row (304), so they have a buffer of their own;
// - K7 is one kernel template over three ops: box (2s+9)/18 (s >= 0, so the
//   division is the floor); sharpen [0,-1,0; -1,5,-1; 0,-1,0] clipped to
//   [0, 255]; Sobel clip(round_half_up(sqrt(gx^2 + gy^2)), 0, 255), exact
//   (sobel_out below).
//
// What bounds them on an H100: bytes (1 read and 1 written per pixel, 8.3 MB
// each way at 4K, plus halo re-reads of 25% of rows for K5 and ~6% for K7).
// K7's design is for that bound: a 256x32 tile whose halo rows are copied
// as the image row's aligned 16-byte words, all in flight at once
// (cp.async; a byte path only for chunks that cross the image's left or
// right edge), into a byte tile; each thread makes
// a 16-wide run on four rows, sliding a 3-row window through registers and
// sharing column sums between neighbours (box: one vertical sum; Sobel:
// a + 2b + c and c - a), and stores the run as one 16-byte vector when the
// rows are 16-byte aligned.
//
// K7's batch axis (the counterpart of jax.vmap of _make_stencil3's kernels):
// uint8[N, H, W] -> uint8[N, H, W] in one launch, image n on grid.z (at most
// 65535). A block's tile and its halo rows lie in its own image (the rows
// clamp to that image's first and last), so no halo reads across two
// images. With W % 16 == 0 every image starts where the first does modulo
// 16, so the aligned path holds for all of them when it holds for the
// first. A single image is launched without the batch offset
// (stencil3_kernel<..., false>).

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"
#include "gauss_tile.cuh"
#include "launch.cuh"

namespace {

// ---- K5 -------------------------------------------------------------------

using ipt::RUN;                         // outputs per thread per row
constexpr int G_TILE_W = 32 * RUN;      // a warp spans the tile's width
constexpr int G_TY = 4;                 // warps
constexpr int G_TILE_H = 16;
constexpr int G_ROWS = G_TILE_H / G_TY;  // output rows per thread
constexpr int G_HALO_H = G_TILE_H + 4;
constexpr int G_THREADS = 32 * G_TY;
// 16-byte chunks per staged row: 16 bytes left of the tile, the tile and two
// halo columns; with up to 15 bytes of lead, one chunk more.
constexpr int G_CHUNKS = G_TILE_W / 16 + 2;
constexpr int G_STRIDE = 16 * (G_CHUNKS + 1);
constexpr int G_BUF_BYTES = G_HALO_H * G_STRIDE;
constexpr int G_HS_BYTES = G_HALO_H * 2 * G_TILE_W;
// Dynamic shared memory: two staging buffers, the sums, the mbarriers.
constexpr int G_SMEM_BYTES = 2 * G_BUF_BYTES + G_HS_BYTES + 2 * 8;
static_assert(G_HALO_H % G_TY == 0 && G_HALO_H <= G_THREADS, "a thread stages a halo row");

// Columns c .. c + 3 (the bytes of w) with even and odd columns apart, in
// 16-bit halves: e = (c, c + 2), o = (c + 1, c + 3).
__device__ __forceinline__ void unpack4(uint32_t w, uint32_t& e, uint32_t& o) {
    e = __byte_perm(w, 0, 0x4240);
    o = __byte_perm(w, 0, 0x4341);
}

// kAligned: src and W are multiples of 16 and out of 8, so every staged row
// starts on a 16-byte boundary (lead 0) and every run stores 8 bytes.
//
// A block stays resident and takes tiles blockIdx.x, + gridDim.x, ...; it
// stages tile i + 1 in one buffer while it computes tile i from the other.
template <bool kAligned>
__global__ void __launch_bounds__(G_THREADS)
gaussian_blur_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out, int H, int W,
                     int tiles_x, int tiles) {
    // buf[k] row r: image row clamp(y0 - 2 + r), from column x0 - 16 - lead on,
    // so that column x0 sits at byte 16 + lead. h_s row r, word 4 l + m: the
    // horizontal sums h[m] of columns x0 + 8 l .. + 7 of that row (hsum8).
    extern __shared__ __align__(16) uint8_t smem[];
    auto buf = reinterpret_cast<uint8_t (*)[G_HALO_H][G_STRIDE]>(smem);
    auto h_s = reinterpret_cast<uint32_t (*)[G_TILE_W / 2]>(smem + 2 * G_BUF_BYTES);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * G_BUF_BYTES + G_HS_BYTES);

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    if (tid == 0) {
        ipt::mbar_init(&full[0], G_HALO_H);
        ipt::mbar_init(&full[1], G_HALO_H);
    }
    __syncthreads();
    auto halo_row = [&](int y0, int r) {
        return src + static_cast<size_t>(min(max(y0 + r - 2, 0), H - 1)) * W;
    };
    // How far a row starts past a 16-byte boundary (x0 is a multiple of 16,
    // so every tile of the row has the same lead).
    auto lead_of = [&](const uint8_t* row) {
        return kAligned ? 0 : static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
    };
    // 1. Stage tile t in buf[k]: thread r < G_HALO_H stages halo row r.
    auto load = [&](int t, int k) {
        if (tid >= G_HALO_H) return;
        const int x0 = (t % tiles_x) * G_TILE_W, y0 = (t / tiles_x) * G_TILE_H;
        const uint8_t* row = halo_row(y0, tid);
        ipt::stage_row<kAligned ? G_CHUNKS : G_CHUNKS + 1>(buf[k][tid], row,
                                                           x0 - 16 - lead_of(row), W, &full[k]);
    };

    const int first = blockIdx.x, step = gridDim.x;  // the launch makes first < tiles
    load(first, 0);
    __syncthreads();  // the first tile's edge bytes (later tiles': the loop's barriers)
    for (int t = first, i = 0; t < tiles; t += step, ++i) {
        const int k = i & 1;
        if (t + step < tiles) load(t + step, k ^ 1);
        const int x0 = (t % tiles_x) * G_TILE_W, y0 = (t / tiles_x) * G_TILE_H;
        ipt::mbar_wait(&full[k], (i >> 1) & 1);

        // 2. The horizontal pass: warp w takes halo rows w, w + G_TY, ...; lane
        // l the 8 columns x = x0 + 8 l .. + 7, from the 16 bytes of columns
        // x - 4 .. x + 11 (lane 0's reach left to byte 12 + lead, lane 31's
        // right to byte 283 + lead). In the tiles at the image's left or right
        // edge, columns left of 0 take column 0's value and columns from W on
        // take column W - 1's.
        const bool at_edge = x0 == 0 || x0 + G_TILE_W + 2 > W;
#pragma unroll
        for (int j = 0; j < G_HALO_H / G_TY; ++j) {
            const int r = warp + G_TY * j;
            const uint8_t* row_s = buf[k][r] + 16 + lead_of(halo_row(y0, r));  // column x0
            const uint8_t* p = row_s + RUN * lane;
            uint32_t w[4];
            if (kAligned) {
                const uint2 q = *reinterpret_cast<const uint2*>(p);
                w[0] = *reinterpret_cast<const uint32_t*>(p - 4);
                w[1] = q.x;
                w[2] = q.y;
                w[3] = *reinterpret_cast<const uint32_t*>(p + 8);
            } else {
                ipt::load_words<false, 4>(p - 4, w);
            }
            uint32_t e[4], o[4];
#pragma unroll
            for (int g = 0; g < 4; ++g) unpack4(w[g], e[g], o[g]);
            if (at_edge) {
                const uint32_t last = row_s[min(W - 1 - x0, G_TILE_W + 1)];
                const int n = W - x0 - RUN * lane;  // columns from x on inside the image
#pragma unroll
                for (int g = 1; g < 4; ++g) ipt::clamp_right(e[g], o[g], n - 4 * (g - 1), last);
                if (x0 == 0 && lane == 0) e[0] = o[0] = e[1] << 16;  // column 0's value
            }
            uint32_t h[4];
            ipt::hsum8(e[0], o[0], e[1], o[1], e[2], o[2], e[3], o[3], h);
            *reinterpret_cast<uint4*>(&h_s[r][4 * lane]) = make_uint4(h[0], h[1], h[2], h[3]);
        }
        __syncthreads();

        // 3. The vertical pass: lane l, warp w makes columns x .. x + 7 of
        // output rows y0 + G_ROWS w .. + G_ROWS - 1 from h_s rows G_ROWS w ..
        // G_ROWS w + G_ROWS + 3.
        const int x = x0 + RUN * lane;
        if (x < W) {
            const int r0 = G_ROWS * warp;
            uint32_t h[G_ROWS + 4][4];
#pragma unroll
            for (int j = 0; j < G_ROWS + 4; ++j) {
                const uint4 q = *reinterpret_cast<const uint4*>(&h_s[r0 + j][4 * lane]);
                h[j][0] = q.x;
                h[j][1] = q.y;
                h[j][2] = q.z;
                h[j][3] = q.w;
            }
            const int n = min(RUN, W - x);
#pragma unroll
            for (int j = 0; j < G_ROWS; ++j) {
                const int y = y0 + r0 + j;
                if (y >= H) break;
                uint32_t lo, hi;
                ipt::vsum8(h[j], h[j + 1], h[j + 2], h[j + 3], h[j + 4], lo, hi);
                ipt::store_run<kAligned>(out + static_cast<size_t>(y) * W + x, lo, hi, n);
            }
        }
        __syncthreads();  // step 3's reads of h_s, and step 2's of buf[k], are done
    }
}

template <bool kAligned>
int launch_gaussian_blur(const uint8_t* src, uint8_t* out, int H, int W, int device,
                         cudaStream_t stream) {
    const auto kernel = gaussian_blur_kernel<kAligned>;
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, G_THREADS,
                                                            G_SMEM_BYTES);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles_x = (W + G_TILE_W - 1) / G_TILE_W;
    const int tiles = tiles_x * ((H + G_TILE_H - 1) / G_TILE_H);
    const int grid = min(tiles, max(per_sm, 1) * sms);
    // The aligned instance was chosen by src's 16 bytes and out's 8.
    return static_cast<int>(ipt::launch(kernel, grid, G_THREADS, G_SMEM_BYTES, stream,
                                        {kAligned ? 16 : 1, kAligned ? 8 : 1}, src, out, H, W,
                                        tiles_x, tiles));
}

// ---- K7 -------------------------------------------------------------------

// A block of 128 threads owns a 256x32 output tile (four to an SM). Thread
// (tx, ty) makes the 16-wide run at columns x0 + 16 tx of rows y0 + 4 ty ..
// + 3, sliding a 3-row window down.
constexpr int S_RUN = 16;
constexpr int S_TX = 16;
constexpr int S_TY = 8;
constexpr int S_ROWS = 4;
constexpr int S_TILE_W = S_RUN * S_TX;
constexpr int S_TILE_H = S_ROWS * S_TY;
constexpr int S_HALO_H = S_TILE_H + 2;
constexpr int S_CHUNKS = S_TILE_W / 16 + 2;  // 16-byte chunks per halo row
constexpr int S_STRIDE = S_CHUNKS * 16;
constexpr int S_THREADS = S_TX * S_TY;

// Each op maps three rows of 18 values (columns x - 1 .. x + 16) to the 16
// outputs at columns x .. x + 15, reusing per-column sums between neighbours.
struct BoxBlur {
    __device__ static void run(const int* a, const int* b, const int* c, int* o) {
        int s[S_RUN + 2];
#pragma unroll
        for (int i = 0; i < S_RUN + 2; ++i) s[i] = a[i] + b[i] + c[i];
#pragma unroll
        for (int i = 0; i < S_RUN; ++i) {
            const unsigned t = s[i] + s[i + 1] + s[i + 2];  // >= 0: the division floors
            o[i] = static_cast<int>((2u * t + 9u) / 18u);
        }
    }
};

struct Sharpen {
    __device__ static void run(const int* a, const int* b, const int* c, int* o) {
#pragma unroll
        for (int i = 0; i < S_RUN; ++i) {
            const int s = 5 * b[i + 1] - a[i + 1] - c[i + 1] - b[i] - b[i + 2];
            o[i] = min(max(s, 0), 255);
        }
    }
};

// Sobel's output min(round_half_up(sqrt(m)), 255) for 0 <= m < 2^23, exact.
// m is exact in f32, and s = m * rsqrt(m) is within a relative 2^-21 of
// sqrt(m). No integer m has sqrt(m) within 4.9e-4 of a half-integer below
// 255.5 (m = k^2 + k is 0.25 / (2k + 1) away), so rounding s to the nearest
// integer (the 2^23 trick) gives round_half_up(sqrt(m)) wherever it is
// below 255, and at least 255 wherever the answer is (m >= 64771, sqrt(m) >=
// 254.502). ipt_sobel_out_test holds it to ops/stencil.py::_isqrt_round,
// clipped, for every m Sobel can make.
__device__ __forceinline__ int sobel_out(int m) {
    const float f = __fsub_rn(__int_as_float(0x4B000000 | m), 8388608.0f);
    const float s = __fmul_rn(f, rsqrtf(fmaxf(f, 1.0f)));
    return min(__float_as_int(__fadd_rn(s, 8388608.0f)) - 0x4B000000, 255);
}

struct Sobel {
    // v = a + 2b + c and d = c - a per column; gx = v[x+1] - v[x-1] and
    // gy = d[x-1] + 2 d[x] + d[x+1] are [-1,0,1; -2,0,2; -1,0,1] and its
    // transpose.
    __device__ static void run(const int* a, const int* b, const int* c, int* o) {
        int v[S_RUN + 2], d[S_RUN + 2];
#pragma unroll
        for (int i = 0; i < S_RUN + 2; ++i) {
            v[i] = a[i] + 2 * b[i] + c[i];
            d[i] = c[i] - a[i];
        }
#pragma unroll
        for (int i = 0; i < S_RUN; ++i) {
            const int gx = v[i + 2] - v[i];
            const int gy = d[i] + 2 * d[i + 1] + d[i + 2];
            o[i] = sobel_out(gx * gx + gy * gy);
        }
    }
};

__device__ __forceinline__ uint32_t pack4(const int* o) {
    return __byte_perm(__byte_perm(o[0], o[1], 0x0040), __byte_perm(o[2], o[3], 0x0040), 0x5410);
}

// Columns x - 1 .. x + 16 of smem row r, where the run's column x sits at
// byte 16 tx + 16 + lead (lead = 0 when every row is 16-byte aligned).
template <bool kAligned>
__device__ __forceinline__ void read_run(const uint8_t* row, int tx, int lead, int* v) {
    const uint8_t* p = row + S_RUN * tx + 16 + lead;
    if (kAligned) {
        const uint4 q = *reinterpret_cast<const uint4*>(p);
        const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int i = 0; i < S_RUN; ++i) v[i + 1] = (w[i / 4] >> (8 * (i % 4))) & 0xFF;
    } else {
#pragma unroll
        for (int i = 0; i < S_RUN; ++i) v[i + 1] = p[i];
    }
    v[0] = p[-1];
    v[S_RUN + 1] = p[S_RUN];
}

// kAligned: src, out and W are multiples of 16, so every row starts on a
// 16-byte boundary and the runs load and store as 16-byte vectors. kBatch:
// image blockIdx.z of the batch; a single image is compiled without its
// offset.
template <class Op, bool kAligned, bool kBatch>
__global__ void __launch_bounds__(S_THREADS, 4)
stencil3_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out, int H, int W) {
    // smem row r holds image row clamp(y0 - 1 + r) from column
    // x0 - 16 - lead[r] on, so that its 16-byte chunks are the row's aligned
    // 16-byte words; columns outside [0, W) are clamped byte by byte.
    __shared__ __align__(16) uint8_t tile[S_HALO_H][S_STRIDE];
    __shared__ int lead_s[S_HALO_H];

    const int tx = threadIdx.x, ty = threadIdx.y;
    const int x0 = blockIdx.x * S_TILE_W;
    const int y0 = blockIdx.y * S_TILE_H;
    if constexpr (kBatch) {
        const size_t image = static_cast<size_t>(blockIdx.z) * H * W;  // image blockIdx.z's offset
        src += image;
        out += image;
    }
    for (int r = ty; r < S_HALO_H; r += S_TY) {
        const uint8_t* row = src + static_cast<size_t>(min(max(y0 + r - 1, 0), H - 1)) * W;
        const int lead = kAligned ? 0 : static_cast<int>((reinterpret_cast<uintptr_t>(row) + x0) & 15);
        if (tx == 0) lead_s[r] = lead;
        for (int j = tx; j < S_CHUNKS; j += S_TX) {
            const int xc = x0 - 16 - lead + 16 * j;
            if (xc >= 0 && xc + 16 <= W) {  // every copy of the block in flight at once
                __pipeline_memcpy_async(&tile[r][16 * j], row + xc, 16);
            } else {  // the image's left or right edge: replicate
                uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
                for (int i = 0; i < 16; ++i) {
                    w[i / 4] |= static_cast<uint32_t>(__ldg(row + min(max(xc + i, 0), W - 1)))
                                << (8 * (i % 4));
                }
                *reinterpret_cast<uint4*>(&tile[r][16 * j]) = make_uint4(w[0], w[1], w[2], w[3]);
            }
        }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    const int x = x0 + S_RUN * tx;
    const int r0 = S_ROWS * ty;  // smem row of the first output row's upper neighbour
    if (x >= W || y0 + r0 >= H) return;
    int a[S_RUN + 2], b[S_RUN + 2], c[S_RUN + 2], o[S_RUN];
    read_run<kAligned>(tile[r0], tx, lead_s[r0], a);
    read_run<kAligned>(tile[r0 + 1], tx, lead_s[r0 + 1], b);
#pragma unroll
    for (int i = 0; i < S_ROWS; ++i) {
        read_run<kAligned>(tile[r0 + 2 + i], tx, lead_s[r0 + 2 + i], c);
        Op::run(a, b, c, o);
        const int y = y0 + r0 + i;
        if (y < H) {
            uint8_t* dst = out + static_cast<size_t>(y) * W + x;
            if (kAligned && x + S_RUN <= W) {
                *reinterpret_cast<uint4*>(dst) =
                    make_uint4(pack4(o), pack4(o + 4), pack4(o + 8), pack4(o + 12));
            } else {
#pragma unroll
                for (int k = 0; k < S_RUN; ++k) {
                    if (x + k < W) dst[k] = static_cast<uint8_t>(o[k]);
                }
            }
        }
#pragma unroll
        for (int k = 0; k < S_RUN + 2; ++k) {
            a[k] = b[k];
            b[k] = c[k];
        }
    }
}

template <class Op>
int launch_stencil3(const void* src, void* out, int N, int H, int W, int device, void* stream) {
    if (N < 1 || N > 65535) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((W + S_TILE_W - 1) / S_TILE_W, (H + S_TILE_H - 1) / S_TILE_H, N);
    const dim3 block(S_TX, S_TY);
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out) | W) & 15) == 0;
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* in = static_cast<const uint8_t*>(src);
    auto* o = static_cast<uint8_t*>(out);
    using Kernel = void (*)(const uint8_t*, uint8_t*, int, int);
    const Kernel kernels[2][2] = {  // [aligned][a batch]
        {stencil3_kernel<Op, false, false>, stencil3_kernel<Op, false, true>},
        {stencil3_kernel<Op, true, false>, stencil3_kernel<Op, true, true>}};
    const int a = aligned ? 16 : 1;  // the instance was chosen by both addresses
    return static_cast<int>(ipt::launch(kernels[aligned][N > 1], grid, block, 0, s, {a, a}, in, o,
                                        H, W));
}

constexpr int THREADS = 256;  // of the test kernel below

__global__ void sobel_out_kernel(int* out, int n) {
    const int m = blockIdx.x * blockDim.x + threadIdx.x;
    if (m < n) out[m] = sobel_out(m);
}

}  // namespace

extern "C" int ipt_gaussian_blur(const void* src, void* out, int H, int W, int device,
                                 void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool aligned = ((reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(W)) & 15) == 0 &&
                         (reinterpret_cast<uintptr_t>(out) & 7) == 0;
    const auto* in = static_cast<const uint8_t*>(src);
    auto* o = static_cast<uint8_t*>(out);
    const auto s = static_cast<cudaStream_t>(stream);
    return aligned ? launch_gaussian_blur<true>(in, o, H, W, device, s)
                   : launch_gaussian_blur<false>(in, o, H, W, device, s);
}

extern "C" int ipt_box_blur(const void* src, void* out, int H, int W, int device,
                            void* stream) {
    return launch_stencil3<BoxBlur>(src, out, 1, H, W, device, stream);
}

extern "C" int ipt_sharpen(const void* src, void* out, int H, int W, int device,
                           void* stream) {
    return launch_stencil3<Sharpen>(src, out, 1, H, W, device, stream);
}

extern "C" int ipt_sobel(const void* src, void* out, int H, int W, int device,
                         void* stream) {
    return launch_stencil3<Sobel>(src, out, 1, H, W, device, stream);
}

// K7 over a batch: src uint8[N, H, W] -> out uint8[N, H, W], in one launch.
extern "C" int ipt_box_blur_batch(const void* src, void* out, int N, int H, int W, int device,
                                  void* stream) {
    return launch_stencil3<BoxBlur>(src, out, N, H, W, device, stream);
}

extern "C" int ipt_sharpen_batch(const void* src, void* out, int N, int H, int W, int device,
                                 void* stream) {
    return launch_stencil3<Sharpen>(src, out, N, H, W, device, stream);
}

extern "C" int ipt_sobel_batch(const void* src, void* out, int N, int H, int W, int device,
                               void* stream) {
    return launch_stencil3<Sobel>(src, out, N, H, W, device, stream);
}

// Test entry: out[m] = Sobel's clipped root of m for 0 <= m < n (int32 out[n]).
extern "C" int ipt_sobel_out_test(void* out, int n, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(ipt::launch(sobel_out_kernel, (n + THREADS - 1) / THREADS, THREADS, 0,
                                        static_cast<cudaStream_t>(stream), {},
                                        static_cast<int*>(out), n));
}
