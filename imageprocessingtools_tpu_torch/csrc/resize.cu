// K9: one separable bicubic resize pass, byte-identical to the C reference.
//
// The JAX package has no Pallas kernel here: its resize scatters the taps
// into dense [out, in] matrices and multiplies on the matrix unit
//   imageprocessingtools_tpu/ops/resize.py::_apply_pass
// (float32 sums, a budget of 2 against the C), because the TPU has no f64 and
// no fast gather; its exact mode is a host loop. Hopper has both, so this
// kernel computes the reference's own tap sum (ppmx-edward.c:820-868,
// golden/model.py::_apply_contributions) from the tables of
// ops/_exact.py::calc_contributions:
//
//   dim 0: out[o, x, c] = quantize(sum_z src[idx[o, z], x, c] * w[o, z])
//   dim 1: out[y, o, c] = quantize(sum_z src[y, idx[o, z], c] * w[o, z])
//
// over z = 0 .. taps - 1 in that order, from 0.0, each product and each sum
// rounded once on its own (tap: the product one exact fused operation, the sum
// its own __dadd_rn; a product contracted into its sum moves a rounded byte),
// then floor(acc + 0.5), < 0 -> 0, >= 256 -> 255 (quantize). The tables are
// used as they are: mirrored indices repeat and run backwards near an edge,
// and zero-weight taps stay (adding 0.0 * px is exact). One launch per pass; the uint8 image
// between the two passes of a resize is the C's own. The tap loop is a
// run-time loop (8 taps at 4K -> 1920, 57 at 4K -> 256, tens of thousands for
// extreme aspect ratios): nothing is sized by the tap count. Offsets are
// 64-bit and both grids of one image are one-dimensional, so no 65535 limit
// applies to an image.
//
// A batch of N images of one shape (jax.vmap's one op over the batch:
// imageprocessingtools_tpu/serving.py::_jitted_local_vmap over ops/resize.py)
// is one launch per pass with the same tables: along dim 1 the rows of all N
// images are one image of N * H rows (rows are independent there); along dim
// 0 image blockIdx.y of the batch, its source H * row_bytes and its output
// out_size * row_bytes apart, so N is at most 65535. A single image runs
// the kBatch = false instance, which has no batch offset.
//
// What bounds it on an H100: f64 operations, one product and one sum per
// byte and tap, each a whole FP64 issue slot (132 SMs x 64 lanes, about 16.7
// T op/s): 299 M at 4K -> 1920, about 18 us, against 56 MB, 17 us; 191 M at
// 4K -> 256 (57 taps), 11 us. A tap is exactly those two (DFMA, DADD); the
// byte needs no conversion (its bits go under 2^52's exponent), only a byte
// permute (PRMT). What else a tap issues (its pixel's shared loads, the
// table's broadcasts, loop and address work) shares the SM's issue slots and
// its shared-memory port with them, and sets how near the kernel comes to the
// f64 bound (PERF.md has its times).
//
// - dim 0 (the H pass): a thread owns vec (8, 4, 2 or 1) neighbouring bytes of
//   one output row, so a tap is one aligned vec-byte load (byte loads where
//   rows or buffers are not vec-byte aligned); idx[o, z] and w[o, z] are the
//   same for the whole block and are read as broadcasts. The host picks vec
//   (kernels/resize.py::rows_vec): the most bytes a thread that still give
//   every SM 4 blocks, so that a narrow output (4K -> 256: 144 rows of 768
//   bytes) fills the card with 864 blocks rather than 144.
// - dim 1 (the W pass): lanes on rows. The pass's work is a grid of items, a
//   group of `outs` neighbouring outputs by a tile of 32 * K rows of the batch;
//   one wave of resident blocks takes equal runs of them, a group's tiles one
//   after another. A warp takes one output at a time, its 32 lanes 32 rows (K
//   each), so each tap's offset and weight are the same for the whole warp:
//   broadcasts, four taps' worth to a 16-byte load. A block stages a group's
//   tables once, when it comes to it (once or twice in its life), with each
//   weight's addend -2^52 * w beside it so that its DMUL leaves the loop; the
//   source columns that the group's tables reach, of the next tiles' rows, are
//   copied into shared memory (cp.async, 4-byte words, pointer-based) while
//   this tile's sums run (two buffers). A staged row's pitch is an odd number
//   of words, so 32 lanes on 32 rows, a byte load each a tap, read 32 banks:
//   those shared loads and the loop's other issue, not the FP64 unit, set the
//   pace (PERF.md). The sums go through a shared output tile, so that each
//   row's outputs leave as one contiguous run. launch_cols plans the pass
//   from the shape (taps, cols / out_size, channels) and the card's shared
//   memory (cols_plan.cuh: K, outs, the columns a staged row holds); a group
//   whose tables reach further (tables that are not the reference's) reads
//   its pixels and tables from global memory instead, and where even the
//   fewest outputs' columns do not fit shared memory (a downscale beyond
//   about 1/80 at 3 channels) the whole pass gathers so: slower, the same
//   sums.
//
// The graph's bind (csrc/launch.cuh, utils/graphs.py) points a replay's
// kernel nodes at a caller's input and output by rewriting their pointer
// arguments. So every pass reads src and writes dst only through those plain
// pointer arguments of a launch made through ipt::launch, with a note of the
// alignment its host code chose a kernel by (dim 0: vec; dim 1: none, its
// copies take any address). No copy may hold the address elsewhere, as a TMA
// tensor map would inside its descriptor: a replay would then read the bytes
// of the capture's buffer.

#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "cols_plan.cuh"
#include "launch.cuh"

namespace {

constexpr int THREADS = 128;       // dim 0: threads a block
constexpr int COLS_WARPS = ipt::cols::WARPS;  // dim 1: warps a block
constexpr int COLS_THREADS = 32 * COLS_WARPS;
constexpr int STAGES = ipt::cols::STAGES;     // dim 1: tile buffers a block

// -2^52 * w, exact: the addend that makes tap's fused product exact.
__device__ __forceinline__ double neg_shift(double w) {
    return __dmul_rn(w, -4503599627370496.0);
}

// One tap: acc + b * w for a byte b, the product and the sum each rounded
// once. The product is one fused operation on (2^52 + b), which is the byte's
// bits under the exponent of 2^52: (2^52 + b) * w - 2^52 * w is b * w before
// rounding, so the FMA rounds it once, to __dmul_rn(b, w). (For b = 0 and a
// negative w it gives +0.0 where the multiply gives -0.0; acc starts at +0.0
// and x + -x rounds to +0.0, so acc is never -0.0 and acc + ±0 is acc.) The
// sum is its own __dadd_rn: the product is never contracted into it.
__device__ __forceinline__ double tap(double acc, uint32_t b, double w, double nw) {
    return __dadd_rn(acc, __fma_rn(__hiloint2double(0x43300000, static_cast<int>(b)), w, nw));
}

// Byte k of word, alone in a word (one PRMT).
__device__ __forceinline__ uint32_t byte_of(uint32_t word, int k) {
    return __byte_perm(word, 0, 0x4440 | k);
}

__device__ __forceinline__ uint32_t quantize(double acc) {
    // floor(acc + 0.5), then the reference's clamp; |acc| is a few hundred at most.
    const int v = __double2int_rd(__dadd_rn(acc, 0.5));
    return static_cast<uint32_t>(min(max(v, 0), 255));
}

// dim 0's V bytes, loaded at once as words.
template <int V> struct Bytes { uint32_t v[V / 4]; };
template <> struct Bytes<2> { uint16_t v[1]; };
template <> struct Bytes<1> { uint8_t v[1]; };

// dim 0. Block b owns bytes [piece * THREADS * V, ...) of output row
// b / pieces, V of them per thread. kWords: rows and buffers are V-byte
// aligned, so a tap is one V-byte load. kBatch: image blockIdx.y of a batch
// whose sources are src_image bytes apart and outputs dst_image bytes apart.
template <int V, bool kWords, bool kBatch>
__global__ void __launch_bounds__(THREADS)
pass_rows_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                 const int* __restrict__ idx, const double* __restrict__ w,
                 long long row_bytes, int taps, long long pieces, long long src_image,
                 long long dst_image) {
    struct alignas(V) Words : Bytes<V> {};
    if constexpr (kBatch) {
        src += blockIdx.y * src_image;
        dst += blockIdx.y * dst_image;
    }
    const long long o = blockIdx.x / pieces;
    const long long j = ((blockIdx.x % pieces) * THREADS + threadIdx.x) * V;
    if (j >= row_bytes) return;
    const int n = kWords ? V : static_cast<int>(min(static_cast<long long>(V), row_bytes - j));
    const int* row_idx = idx + o * taps;
    const double* row_w = w + o * taps;
    double acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0;
#pragma unroll 4
    for (int z = 0; z < taps; ++z) {
        const uint8_t* p = src + __ldg(row_idx + z) * row_bytes + j;
        const double wz = __ldg(row_w + z), nwz = neg_shift(wz);
        if (kWords) {
            const Words x = *reinterpret_cast<const Words*>(p);
#pragma unroll
            for (int k = 0; k < V; ++k) {
                acc[k] = tap(acc[k], byte_of(x.v[k / 4], k % 4), wz, nwz);
            }
        } else {
#pragma unroll
            for (int k = 0; k < V; ++k) {
                if (k < n) acc[k] = tap(acc[k], __ldg(p + k), wz, nwz);
            }
        }
    }
    uint8_t* q = dst + o * row_bytes + j;
    if (kWords) {
        Words y;
#pragma unroll
        for (int k = 0; k < (V + 3) / 4; ++k) {
            uint32_t word = 0;
#pragma unroll
            for (int b = 0; b < 4 && 4 * k + b < V; ++b) word |= quantize(acc[4 * k + b]) << (8 * b);
            y.v[k] = word;
        }
        *reinterpret_cast<Words*>(q) = y;
    } else {
#pragma unroll
        for (int k = 0; k < V; ++k) {
            if (k < n) q[k] = static_cast<uint8_t>(quantize(acc[k]));
        }
    }
}

// n images of in_rows rows each (n > 1: the kBatch instance, image on grid.y).
template <int V>
cudaError_t launch_rows(const uint8_t* src, uint8_t* dst, const int* idx, const double* w,
                        long long row_bytes, long long out_size, int taps, long long n,
                        long long in_rows, cudaStream_t stream) {
    const long long pieces = (row_bytes + THREADS * V - 1) / (THREADS * V);
    const long long blocks = out_size * pieces;
    if (blocks > INT_MAX || n < 1 || n > 65535) return cudaErrorInvalidConfiguration;
    // Every image's rows start V-byte aligned when the first's do: images
    // are whole rows apart.
    const bool words = V > 1 && row_bytes % V == 0 && reinterpret_cast<uintptr_t>(src) % V == 0 &&
                       reinterpret_cast<uintptr_t>(dst) % V == 0;
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n));
    using Kernel = void (*)(const uint8_t*, uint8_t*, const int*, const double*, long long, int,
                            long long, long long, long long);
    const Kernel kernels[2][2] = {  // [words][a batch]
        {pass_rows_kernel<V, false, false>, pass_rows_kernel<V, false, true>},
        {pass_rows_kernel<V, V != 1, false>, pass_rows_kernel<V, V != 1, true>}};
    const int a = words ? V : 1;  // the word instance was chosen by both addresses
    return ipt::launch(kernels[words][n > 1], grid, THREADS, 0, stream, {a, a}, src, dst, idx, w,
                       row_bytes, taps, pieces, in_rows * row_bytes, out_size * row_bytes);
}

// What every thread of a dim 1 block knows of the pass.
struct Cols {
    const uint8_t* src;      // the batch's rows, row_bytes each
    const uint8_t* src_end;
    uint8_t* dst;            // rows of out_size pixels
    const int* idx;
    const double* w;
    long long rows, row_bytes, out_size;
    int taps, tz, span, pitch, out_pitch;  // tz: cols::table_row(taps)
    uint8_t* out_tile;       // shared: the tile's output rows
    int* s_off;              // shared: [outs][tz] each tap's byte offset from column lo
    double* s_w;             // shared: [outs][tz] weights
    double* s_nw;            // shared: [outs][tz] -2^52 * weight
    uint8_t* staged;         // shared: two buffers of the tile's source rows
};

// The block's outputs [o0, o0 + n_out), one group of the pass's.
struct Group {
    long long o0;
    int n_out;
    int lo;                  // the least source column that the group's tables reach
    int reach_bytes;         // bytes from column lo to the end of the largest
    bool tiled;              // that reach fits a staged row: the sums read shared memory
};

// The group's tables into shared memory, each weight's addend beside it,
// and the columns they reach: the least and the largest index, so that
// mirrored and repeated indices need no special case. Where the reach fits
// span, each index becomes its pixel's byte offset from column lo. Ends with
// every thread knowing the group.
template <int C>
__device__ __forceinline__ void stage_tables(const Cols& s, Group& g, int* s_lo, int* s_hi) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long n = static_cast<long long>(g.n_out) * s.taps;
    const int* idx = s.idx + g.o0 * s.taps;
    const double* w = s.w + g.o0 * s.taps;
    int lo = INT_MAX, hi = -1;
    for (long long e = threadIdx.x; e < n; e += COLS_THREADS) {
        const int v = __ldg(idx + e);
        const double wz = __ldg(w + e);
        const long long at = e / s.taps * s.tz + e % s.taps;
        lo = min(lo, v);
        hi = max(hi, v);
        s.s_off[at] = v;
        s.s_w[at] = wz;
        s.s_nw[at] = neg_shift(wz);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xFFFFFFFFu, lo, d));
        hi = max(hi, __shfl_xor_sync(0xFFFFFFFFu, hi, d));
    }
    if (lane == 0) {
        s_lo[warp] = lo;
        s_hi[warp] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < COLS_WARPS; ++k) {
        lo = min(lo, s_lo[k]);
        hi = max(hi, s_hi[k]);
    }
    g.lo = lo;
    g.reach_bytes = (hi - lo + 1) * C;
    g.tiled = hi - lo < s.span;
    if (!g.tiled) return;
    for (long long e = threadIdx.x; e < n; e += COLS_THREADS) {  // each thread its own entries
        const long long at = e / s.taps * s.tz + e % s.taps;
        s.s_off[at] = (s.s_off[at] - lo) * C;
    }
}

// Source rows [t * 32K, ...) of the group's columns into buffer buf, one warp
// a row, as the image's aligned 4-byte words (cp.async, pointer-based: a
// replay reads whatever src the graph's node holds); a word that reaches past
// either end of the image is copied byte by byte. Row r starts at byte
// r * pitch + (its first byte's address & 3).
template <int C, int K>
__device__ __forceinline__ void stage_tile(const Cols& s, const Group& g, long long t, int buf) {
    constexpr int T = 32 * K;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long y0 = t * T;
    const int n_rows = static_cast<int>(min(static_cast<long long>(T), s.rows - y0));
    uint8_t* tile = s.staged + buf * T * s.pitch;
    for (int r = warp; r < n_rows; r += COLS_WARPS) {
        const uint8_t* first = s.src + (y0 + r) * s.row_bytes + static_cast<long long>(g.lo) * C;
        const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(first) & 3);
        const uint8_t* a = first - sh;
        const int words = (sh + g.reach_bytes + 3) / 4;
        uint8_t* to = tile + r * s.pitch;
        if (a >= s.src && a + 4 * words <= s.src_end) {
            for (int j = lane; j < words; j += 32) __pipeline_memcpy_async(to + 4 * j, a + 4 * j, 4);
            continue;
        }
        for (int j = lane; j < words; j += 32) {  // the image's first or last row
            const uint8_t* from = a + 4 * j;
            if (from >= s.src && from + 4 <= s.src_end) {
                __pipeline_memcpy_async(to + 4 * j, from, 4);
            } else {
                for (int b = 0; b < 4; ++b) {
                    if (from + b >= s.src && from + b < s.src_end) to[4 * j + b] = from[b];
                }
            }
        }
    }
}

// One tap of the K rows at row[k] (shared): the pixel's C bytes at offset oz.
template <int C, int K>
__device__ __forceinline__ void tap_rows(double (&acc)[K][C], const uint8_t* const (&row)[K],
                                         int oz, double wz, double nwz) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const uint8_t* p = row[k] + oz;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[k][c] = tap(acc[k][c], p[c], wz, nwz);
    }
}

// The sums of a staged tile: warp w takes the group's outputs w, w + 8, ...,
// lane l the tile's rows l, l + 32, ...: an output's offsets and weights are
// the same for the whole warp (broadcasts, four taps' worth to a 16-byte
// load), and its 32 rows' pixel bytes lie an odd number of words apart (no
// bank conflicts). Into the output tile.
template <int C, int K>
__device__ __forceinline__ void sums_tiled(const Cols& s, const Group& g, long long y0, int buf) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint8_t* row[K];  // row lane + 32 k's byte of column lo
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int r = lane + 32 * k;
        const uintptr_t first = reinterpret_cast<uintptr_t>(s.src) + (y0 + r) * s.row_bytes +
                                static_cast<long long>(g.lo) * C;
        row[k] = s.staged + (buf * 32 * K + r) * s.pitch + static_cast<int>(first & 3);
    }
    for (int o = warp; o < g.n_out; o += COLS_WARPS) {
        const int* off = s.s_off + o * s.tz;
        const double* wo = s.s_w + o * s.tz;
        const double* nwo = s.s_nw + o * s.tz;
        double acc[K][C];
#pragma unroll
        for (int k = 0; k < K; ++k) {
#pragma unroll
            for (int c = 0; c < C; ++c) acc[k][c] = 0.0;
        }
        int z = 0;
        for (; z + 4 <= s.taps; z += 4) {  // four taps a step
            const int4 oz = *reinterpret_cast<const int4*>(off + z);
            const double2 w01 = *reinterpret_cast<const double2*>(wo + z);
            const double2 w23 = *reinterpret_cast<const double2*>(wo + z + 2);
            const double2 n01 = *reinterpret_cast<const double2*>(nwo + z);
            const double2 n23 = *reinterpret_cast<const double2*>(nwo + z + 2);
            tap_rows<C, K>(acc, row, oz.x, w01.x, n01.x);
            tap_rows<C, K>(acc, row, oz.y, w01.y, n01.y);
            tap_rows<C, K>(acc, row, oz.z, w23.x, n23.x);
            tap_rows<C, K>(acc, row, oz.w, w23.y, n23.y);
        }
        for (; z < s.taps; ++z) tap_rows<C, K>(acc, row, off[z], wo[z], nwo[z]);
#pragma unroll
        for (int k = 0; k < K; ++k) {
            uint8_t* q = s.out_tile + (lane + 32 * k) * s.out_pitch + o * C;
#pragma unroll
            for (int c = 0; c < C; ++c) q[c] = static_cast<uint8_t>(quantize(acc[k][c]));
        }
    }
}

// The same sums with the tables and the pixels read from global memory: the
// pass's columns do not fit a staged row.
template <int C, int K>
__device__ __forceinline__ void sums_gathered(const Cols& s, const Group& g, long long y0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint8_t* row[K];  // rows past the end read the last one; nothing stores them
#pragma unroll
    for (int k = 0; k < K; ++k) row[k] = s.src + min(y0 + lane + 32 * k, s.rows - 1) * s.row_bytes;
    for (int o = warp; o < g.n_out; o += COLS_WARPS) {
        const int* io = s.idx + (g.o0 + o) * s.taps;
        const double* wo = s.w + (g.o0 + o) * s.taps;
        double acc[K][C];
#pragma unroll
        for (int k = 0; k < K; ++k) {
#pragma unroll
            for (int c = 0; c < C; ++c) acc[k][c] = 0.0;
        }
#pragma unroll 4
        for (int z = 0; z < s.taps; ++z) {
            const long long at = static_cast<long long>(__ldg(io + z)) * C;
            const double wz = __ldg(wo + z), nwz = neg_shift(wz);
#pragma unroll
            for (int k = 0; k < K; ++k) {
#pragma unroll
                for (int c = 0; c < C; ++c) acc[k][c] = tap(acc[k][c], __ldg(row[k] + at + c), wz, nwz);
            }
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
            uint8_t* q = s.out_tile + (lane + 32 * k) * s.out_pitch + o * C;
#pragma unroll
            for (int c = 0; c < C; ++c) q[c] = static_cast<uint8_t>(quantize(acc[k][c]));
        }
    }
}

// The output tile's n_rows rows to their places, one warp a row: each row's
// bytes of the group are one contiguous run of the output, stored as words
// where the run's address and length allow, else as bytes.
template <int C>
__device__ __forceinline__ void store_tile(const Cols& s, const Group& g, long long y0, int n_rows) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_bytes = g.n_out * C;
    for (int r = warp; r < n_rows; r += COLS_WARPS) {
        uint8_t* q = s.dst + ((y0 + r) * s.out_size + g.o0) * C;
        const uint8_t* from = s.out_tile + r * s.out_pitch;
        if (((reinterpret_cast<uintptr_t>(q) | n_bytes) & 3) == 0) {
            for (int j = lane; j < n_bytes / 4; j += 32) {
                reinterpret_cast<uint32_t*>(q)[j] = reinterpret_cast<const uint32_t*>(from)[j];
            }
        } else {
            for (int j = lane; j < n_bytes; j += 32) q[j] = from[j];
        }
    }
}

// dim 1. The pass's work is items = groups x tiles: group g the outputs
// [g * outs, ...), tile t the rows [t * 32K, ...) of the batch (its images'
// rows are one image's here). Block b walks the items [b * items / grid,
// (b + 1) * items / grid) in order, a group's tiles one after another (so
// every block has the same work, to a tile): it stages a group's tables once,
// when it comes to the group (once or twice in its life), and keeps the
// copies of the group's next tile in flight while it sums one. span: the
// source columns a staged row holds (0: nothing is staged, every group
// gathers).
template <int C, int K>
__global__ void __launch_bounds__(COLS_THREADS, 2)
pass_cols_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                 const int* __restrict__ idx, const double* __restrict__ w,
                 long long rows, long long cols, long long out_size, int taps, int outs,
                 int span, int pitch, int out_pitch, long long tiles, long long items) {
    constexpr int T = 32 * K;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int s_lo[COLS_WARPS], s_hi[COLS_WARPS];

    Cols s;
    s.src = src;
    s.row_bytes = cols * C;
    s.src_end = src + rows * s.row_bytes;
    s.dst = dst;
    s.idx = idx;
    s.w = w;
    s.rows = rows;
    s.out_size = out_size;
    s.taps = taps;
    s.tz = static_cast<int>(ipt::cols::table_row(taps));
    s.span = span;
    s.pitch = pitch;
    s.out_pitch = out_pitch;
    s.out_tile = smem;
    const long long table = outs * ipt::cols::table_row(taps);
    s.s_off = reinterpret_cast<int*>(smem + ipt::cols::tables_at(K, out_pitch));
    s.s_w = reinterpret_cast<double*>(s.s_off + table);
    s.s_nw = s.s_w + table;
    s.staged = smem + ipt::cols::staged_at(K, out_pitch, outs, taps);

    const long long begin = blockIdx.x * items / gridDim.x;
    const long long end = (blockIdx.x + 1) * items / gridDim.x;
    Group g;
    g.o0 = -1;
    long long last = 0;  // the group's last item in this block, plus one
    for (long long i = begin; i < end; ++i) {
        const long long t = i % tiles;
        if (i / tiles * outs != g.o0) {  // a new group: its tables, its first tiles' copies
            g.o0 = i / tiles * outs;
            g.n_out = static_cast<int>(min(static_cast<long long>(outs), out_size - g.o0));
            last = min(end, (i / tiles + 1) * tiles);
            __syncthreads();  // the last group's tables and buffers are used up
            g.tiled = false;
            if (span > 0) stage_tables<C>(s, g, s_lo, s_hi);
            if (g.tiled) {
                for (int k = 0; k < STAGES - 1; ++k) {
                    if (i + k < last) stage_tile<C, K>(s, g, t + k, static_cast<int>((t + k) % STAGES));
                    __pipeline_commit();
                }
            }
        }
        if (g.tiled) {  // the copies of tile t + STAGES - 1, then tile t's have landed
            if (i + STAGES - 1 < last) {
                stage_tile<C, K>(s, g, t + STAGES - 1, static_cast<int>((t + STAGES - 1) % STAGES));
            }
            __pipeline_commit();
            __pipeline_wait_prior(STAGES - 1);
        }
        __syncthreads();  // tile t has landed, the tables are staged, the last outputs stored
        const long long y0 = t * T;
        if (g.tiled) {
            sums_tiled<C, K>(s, g, y0, static_cast<int>(t % STAGES));
        } else {
            sums_gathered<C, K>(s, g, y0);
        }
        __syncthreads();  // the output tile is whole
        store_tile<C>(s, g, y0, static_cast<int>(min(static_cast<long long>(T), rows - y0)));
    }
}

// dim 1 over `rows` rows: the plan (cols_plan.cuh) for the shared memory
// that this kernel may take on the card, then one wave of resident blocks.
// Where `planned` is not null, the plan is written there and nothing is
// launched.
template <int C, int K>
cudaError_t launch_cols(const uint8_t* src, uint8_t* dst, const int* idx, const double* w,
                        long long rows, long long cols, long long out_size, int taps, int device,
                        cudaStream_t stream, ipt::cols::Plan* planned) {
    constexpr int T = 32 * K;
    // The most dynamic shared memory a block may take (the card's limit), and
    // what each of two blocks on one SM may take, both less the kernel's
    // static shared memory.
    const auto kernel = pass_cols_kernel<C, K>;
    cudaFuncAttributes attr;
    int block = 0, sm = 0, reserved = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    }
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
    }
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
    }
    if (err != cudaSuccess) return err;
    const int most = block - static_cast<int>(attr.sharedSizeBytes);
    const int aim = sm / 2 - reserved - static_cast<int>(attr.sharedSizeBytes);
    const ipt::cols::Plan p = ipt::cols::plan(cols, C, out_size, taps, most, aim);
    if (planned) {
        *planned = p;
        return cudaSuccess;
    }
    // Set to the most, not to this launch's own, so that a graph captured
    // earlier with more stays valid.
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, COLS_THREADS,
                                                            static_cast<size_t>(p.smem));
    }
    if (err != cudaSuccess) return err;
    const long long tiles = (rows + T - 1) / T;
    const long long items = (out_size + p.outs - 1) / p.outs * tiles;
    const long long blocks = min(items, static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms);
    // Any address: the kernel takes rows and words at whatever alignment they have.
    return ipt::launch(kernel, static_cast<unsigned>(blocks), COLS_THREADS,
                       static_cast<size_t>(p.smem), stream, {}, src, dst, idx, w, rows, cols,
                       out_size, taps, p.outs, p.span, p.pitch, p.out_pitch, tiles, items);
}

// launch_cols for `channels` (1 or 3) and the rows a lane that `taps` give.
cudaError_t launch_cols_for(int channels, const uint8_t* src, uint8_t* dst, const int* idx,
                            const double* w, long long rows, long long cols, long long out_size,
                            int taps, int device, cudaStream_t stream,
                            ipt::cols::Plan* planned = nullptr) {
    using Launch = cudaError_t (*)(const uint8_t*, uint8_t*, const int*, const double*, long long,
                                   long long, long long, int, int, cudaStream_t, ipt::cols::Plan*);
    const Launch launches[2][2] = {  // [3 channels][one row a lane]
        {launch_cols<1, 2>, launch_cols<1, 1>}, {launch_cols<3, 2>, launch_cols<3, 1>}};
    return launches[channels == 3][ipt::cols::lane_rows(taps) == 1](
        src, dst, idx, w, rows, cols, out_size, taps, device, stream, planned);
}

// One pass over n images src uint8[n][rows, cols, channels], one after
// another (see ipt_resize_pass).
int resize_pass(const void* src, void* dst, const void* idx, const void* w, long long n,
                long long rows, long long cols, int channels, long long out_size, int taps,
                int dim, int vec, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if ((channels != 1 && channels != 3) || (dim != 0 && dim != 1) || rows < 1 || cols < 1 ||
        out_size < 1 || taps < 1 || n < 1 ||
        (dim == 0 && vec != 1 && vec != 2 && vec != 4 && vec != 8)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto s = static_cast<const uint8_t*>(src);
    const auto d = static_cast<uint8_t*>(dst);
    const auto i = static_cast<const int*>(idx);
    const auto wt = static_cast<const double*>(w);
    const auto st = static_cast<cudaStream_t>(stream);
    if (dim == 1) {  // the batch's rows are one image's
        return static_cast<int>(
            launch_cols_for(channels, s, d, i, wt, n * rows, cols, out_size, taps, device, st));
    }
    const long long row_bytes = cols * channels;
    switch (vec) {
        case 8: err = launch_rows<8>(s, d, i, wt, row_bytes, out_size, taps, n, rows, st); break;
        case 4: err = launch_rows<4>(s, d, i, wt, row_bytes, out_size, taps, n, rows, st); break;
        case 2: err = launch_rows<2>(s, d, i, wt, row_bytes, out_size, taps, n, rows, st); break;
        default: err = launch_rows<1>(s, d, i, wt, row_bytes, out_size, taps, n, rows, st); break;
    }
    return static_cast<int>(err);
}

}  // namespace

// One pass over src uint8[rows, cols, channels] (channels 1 or 3) with the
// tables idx int32[out_size, taps] and w float64[out_size, taps]: dim 0 writes
// dst uint8[out_size, cols, channels] with vec (8, 4, 2 or 1) bytes per
// thread, dim 1 dst uint8[rows, out_size, channels].
extern "C" int ipt_resize_pass(const void* src, void* dst, const void* idx, const void* w,
                               long long rows, long long cols, int channels, long long out_size,
                               int taps, int dim, int vec, int device, void* stream) {
    return resize_pass(src, dst, idx, w, 1, rows, cols, channels, out_size, taps, dim, vec,
                       device, stream);
}

// The same pass over each of n images (1 <= n <= 65535) of one shape, one
// after another in src uint8[n, rows, cols, channels] and dst, with the same
// tables, in one launch.
extern "C" int ipt_resize_pass_batch(const void* src, void* dst, const void* idx, const void* w,
                                     int n, long long rows, long long cols, int channels,
                                     long long out_size, int taps, int dim, int vec, int device,
                                     void* stream) {
    if (n < 1 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
    return resize_pass(src, dst, idx, w, n, rows, cols, channels, out_size, taps, dim, vec,
                       device, stream);
}

// The path of the W pass (dim 1) that ipt_resize_pass plans on `device` for
// rows of cols pixels of channels (1 or 3) to out_size with taps taps: *tiled
// 1 where each tile's source rows are staged in shared memory, 0 where the
// pass gathers from global memory. Launches nothing.
extern "C" int ipt_resize_cols_tiled(long long cols, int channels, long long out_size, int taps,
                                     int device, int* tiled) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if ((channels != 1 && channels != 3) || cols < 1 || out_size < 1 || taps < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    ipt::cols::Plan p{};
    err = launch_cols_for(channels, nullptr, nullptr, nullptr, nullptr, 1, cols, out_size, taps,
                          device, nullptr, &p);
    if (err == cudaSuccess) *tiled = p.tiled;
    return static_cast<int>(err);
}
