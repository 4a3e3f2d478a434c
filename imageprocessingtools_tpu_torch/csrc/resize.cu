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
// then floor(acc + 0.5), < 0 -> 0, >= 256 -> 255. The tables are used as they
// are: mirrored indices repeat and run backwards near an edge, and zero-weight
// taps stay (adding 0.0 * px is exact). One launch per pass; the uint8 image
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
// T op/s): 299 M at 4K -> 1920, about 18 us, against 56 MB, 17 us. A tap is
// exactly those two (DFMA, DADD) and one DMUL per tap and thread for the
// product's addend; the byte needs no conversion (its bits go under 2^52's
// exponent), only a byte permute (PRMT) and, in dim 1, two shared loads and a
// funnel shift per pixel, all of which issue at the f64 rate or below. The
// kernel is still far from the bound (PERF.md has its times and what its cuts
// and stamps showed).
//
// - dim 0: a thread owns vec (8, 4, 2 or 1) neighbouring bytes of one output
//   row, so a tap is one aligned vec-byte load (byte loads where rows or
//   buffers are not vec-byte aligned); idx[o, z] and w[o, z] are the same for
//   the whole block and are read as broadcasts. The host picks vec
//   (kernels/resize.py::rows_vec): the most bytes a thread that still give
//   every SM 4 blocks, so that a narrow output (4K -> 256: 144 rows of 768
//   bytes) fills the card with 864 blocks rather than 144.
// - dim 1: a block owns 128 neighbouring outputs of a strip of image rows
//   and walks the strip 4 rows at a time; the grid is one wave of resident
//   blocks. The block finds the source columns its tables reach (their least
//   and largest index, so mirrored and repeated indices need no special
//   case) and stages those columns of the next steps' rows in shared memory
//   as the image's aligned 16-byte chunks (cp.async; as many steps ahead as
//   put 8 KB in flight per block, at most 3: beyond that, shared memory is
//   better spent on more resident blocks). The tables are staged transposed,
//   so that neighbouring threads read neighbouring words: once per block where the
//   taps fit one chunk of 16, else chunk by chunk in every step. A tap is
//   then one index, one weight and, per row, one pixel (3 bytes from two
//   aligned words and a funnel shift) from shared memory. Where the columns
//   do not fit (about 128 / scale + taps pixels per row; a downscale beyond
//   about 1/24 at 3 channels) the block gathers its bytes from global memory
//   instead: slower, the same sums.

#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 4;       // dim 1: image rows per step of a block
constexpr int TAPS = 16;      // dim 1: most taps per staged chunk of the tables
constexpr int PITCH = THREADS + 1;  // staged table rows, padded against bank conflicts
constexpr int MAX_STAGES = 4;       // dim 1: most steps whose rows are in flight or in use
// dim 1: most dynamic shared memory per block (tables and staged rows; two
// blocks to an SM).
constexpr long long SMEM_MAX_BYTES = 100 * 1024;
constexpr long long IN_FLIGHT_BYTES = 8 * 1024;  // dim 1: staged bytes a block keeps ahead

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

// Bytes of shared memory per staged row of seg_bytes image bytes: up to 15
// bytes of head shift, the bytes, the last chunk's tail, and 16 bytes that
// the last pixel's second word may reach into.
__host__ __device__ constexpr long long staged_row_bytes(long long seg_bytes) {
    return (seg_bytes + 15 + 15) / 16 * 16 + 16;
}

// Bytes of the tables' chunk: chunk_taps rows of PITCH weights, then of
// PITCH indices, rounded up so that the staged rows after it are 16-byte aligned.
__host__ __device__ constexpr long long table_bytes(int chunk_taps) {
    return (static_cast<long long>(chunk_taps) * PITCH * 12 + 15) / 16 * 16;
}

// What a dim 1 block knows after its prologue.
struct Strip {
    const uint8_t* src;      // the image, rows of row_bytes
    const uint8_t* src_end;
    uint8_t* dst;            // rows of out_size pixels
    const int* block_idx;    // the block's first output's row of idx
    const double* block_w;
    double* s_w;             // shared: [chunk_taps][PITCH]
    int* s_idx;              // shared: [chunk_taps][PITCH]
    uint8_t* seg;            // shared: [n_stages][ROWS][seg_stride]
    int (*s_shift)[ROWS];    // shared: each staged row's first byte in its 16-byte chunk
    long long row_bytes, out_size, o0, y_begin, y_end;
    int taps, chunk_taps, n_out, seg_stride, n_stages;
    int lo, seg_bytes;       // staged: source columns [lo, ...), seg_bytes of them per row
};

// Taps [z0, z0 + nz) of the block's tables into shared memory, transposed.
// lo and hi take in every index met.
__device__ __forceinline__ void stage_tables(const Strip& s, int z0, int nz, int& lo, int& hi) {
#pragma unroll 4
    for (int e = threadIdx.x; e < s.n_out * nz; e += THREADS) {
        const int ol = e / nz, zl = e - ol * nz;
        const long long g = static_cast<long long>(ol) * s.taps + z0 + zl;
        const int v = __ldg(s.block_idx + g);
        lo = min(lo, v);
        hi = max(hi, v);
        s.s_idx[zl * PITCH + ol] = v;
        s.s_w[zl * PITCH + ol] = __ldg(s.block_w + g);
    }
}

// Step k of the strip (rows y_begin + k * ROWS ...) into its buffer,
// k % n_stages, as the image's aligned 16-byte chunks, every copy in flight at
// once (cp.async); a chunk that reaches past either end of the image is
// copied byte by byte. A step past the strip's end commits an empty group.
__device__ __forceinline__ void stage_rows(const Strip& s, long long k, int channels) {
    const long long y = s.y_begin + k * ROWS;
    const int buf = static_cast<int>(k % s.n_stages);
    for (int r = 0; r < ROWS && y + r < s.y_end; ++r) {
        const uint8_t* g = s.src + (y + r) * s.row_bytes + static_cast<long long>(s.lo) * channels;
        const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
        const uint8_t* a = g - sh;
        const int chunks = (sh + s.seg_bytes + 15) / 16;
        if (threadIdx.x == 0) s.s_shift[buf][r] = sh;
        for (int c = threadIdx.x; c < chunks; c += THREADS) {
            const uint8_t* from = a + 16 * c;
            uint8_t* to = s.seg + static_cast<long long>(buf * ROWS + r) * s.seg_stride + 16 * c;
            if (from >= s.src && from + 16 <= s.src_end) {
                __pipeline_memcpy_async(to, from, 16);
            } else {
                for (int b = 0; b < 16; ++b) {
                    if (from + b >= s.src && from + b < s.src_end) to[b] = from[b];
                }
            }
        }
    }
    __pipeline_commit();
}

// The strip's steps. kStaged: the pixels come from the staged rows, else from
// global memory.
template <int C, bool kStaged>
__device__ __forceinline__ void walk_strip(const Strip& s) {
    const int t = threadIdx.x;
    const bool one_chunk = s.taps <= s.chunk_taps;  // the whole table is staged already
    if (kStaged) {
        for (int k = 0; k < s.n_stages - 1; ++k) stage_rows(s, k, C);
    }
    long long step = 0;
    for (long long y = s.y_begin; y < s.y_end; y += ROWS, ++step) {
        const int n_rows = static_cast<int>(min(static_cast<long long>(ROWS), s.y_end - y));
        const int buf = kStaged ? static_cast<int>(step % s.n_stages) : 0;
        if (kStaged) {  // later steps' copies start before this step's sums
            stage_rows(s, step + s.n_stages - 1, C);
            __pipeline_wait_prior(s.n_stages - 1);
        }
        __syncthreads();  // every thread's copies for this step have landed
        int staged_at[ROWS];  // where row r's pixel lo lies in seg
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            staged_at[r] = kStaged ? (buf * ROWS + r) * s.seg_stride + s.s_shift[buf][r] : 0;
        }
        const uint8_t* src_y = s.src + y * s.row_bytes;
        double acc[ROWS][C];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
#pragma unroll
            for (int c = 0; c < C; ++c) acc[r][c] = 0.0;
        }
        for (int z0 = 0; z0 < s.taps; z0 += s.chunk_taps) {
            const int nz = min(s.chunk_taps, s.taps - z0);
            if (!one_chunk) {
                if (z0 > 0) __syncthreads();  // the last chunk is used up
                int unused_lo = 0, unused_hi = 0;
                stage_tables(s, z0, nz, unused_lo, unused_hi);
                __syncthreads();
            }
            if (t < s.n_out) {
#pragma unroll 4
                for (int zl = 0; zl < nz; ++zl) {
                    const int ix = s.s_idx[zl * PITCH + t];
                    const double wz = s.s_w[zl * PITCH + t], nwz = neg_shift(wz);
#pragma unroll
                    for (int r = 0; r < ROWS; ++r) {
                        if (r < n_rows) {
                            uint32_t px;
                            if (!kStaged) {
                                const uint8_t* p =
                                    src_y + r * s.row_bytes + static_cast<long long>(ix) * C;
                                px = __ldg(p);
                                if (C == 3) px |= (__ldg(p + 1) << 8) | (__ldg(p + 2) << 16);
                            } else if (C == 1) {
                                px = s.seg[staged_at[r] + (ix - s.lo)];
                            } else {  // 3 bytes from two aligned words
                                const int at = staged_at[r] + (ix - s.lo) * C;
                                const uint32_t* wp =
                                    reinterpret_cast<const uint32_t*>(s.seg + (at & ~3));
                                // the funnel shift takes the low 5 bits of at * 8
                                px = __funnelshift_r(wp[0], wp[1], at << 3);
                            }
#pragma unroll
                            for (int c = 0; c < C; ++c) {
                                acc[r][c] = tap(acc[r][c], C == 1 ? px : byte_of(px, c), wz, nwz);
                            }
                        }
                    }
                }
            }
        }
        if (t < s.n_out) {
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
                if (r < n_rows) {
                    uint8_t* q = s.dst + ((y + r) * s.out_size + s.o0 + t) * C;
#pragma unroll
                    for (int c = 0; c < C; ++c) q[c] = static_cast<uint8_t>(quantize(acc[r][c]));
                }
            }
        }
        __syncthreads();  // this step's buffer and the tables' chunk are free
    }
}

// dim 1. Block b owns outputs [bx * THREADS, ...), bx = b % blocks_x, of the
// image rows [strip * strip_rows, ...), strip = b / blocks_x, and walks them
// in steps of ROWS. Dynamic shared memory: the tables' chunk, then n_stages
// steps of ROWS staged rows of seg_stride bytes (n_stages 0: none, the bytes
// are gathered from global memory).
template <int C>
__global__ void __launch_bounds__(THREADS)
pass_cols_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                 const int* __restrict__ idx, const double* __restrict__ w,
                 long long rows, long long cols, long long out_size, int taps,
                 long long blocks_x, long long strip_rows, int chunk_taps, int seg_stride,
                 int n_stages) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int s_lo, s_hi;
    __shared__ int s_shift[MAX_STAGES][ROWS];

    Strip s;
    s.src = src;
    s.dst = dst;
    s.row_bytes = cols * C;
    s.src_end = src + rows * s.row_bytes;
    s.out_size = out_size;
    s.o0 = (blockIdx.x % blocks_x) * THREADS;
    s.y_begin = (blockIdx.x / blocks_x) * strip_rows;
    s.y_end = min(rows, s.y_begin + strip_rows);
    s.block_idx = idx + s.o0 * taps;
    s.block_w = w + s.o0 * taps;
    s.s_w = reinterpret_cast<double*>(smem);
    s.s_idx = reinterpret_cast<int*>(s.s_w + chunk_taps * PITCH);
    s.seg = smem + table_bytes(chunk_taps);
    s.s_shift = s_shift;
    s.taps = taps;
    s.chunk_taps = chunk_taps;
    s.n_out = static_cast<int>(min(static_cast<long long>(THREADS), out_size - s.o0));
    s.seg_stride = seg_stride;
    s.n_stages = n_stages;

    // The source columns [lo, hi] that this block's tables reach; a table that
    // fits one chunk is staged on the way.
    int lo = INT_MAX, hi = -1;
    if (threadIdx.x == 0) {
        s_lo = INT_MAX;
        s_hi = -1;
    }
    __syncthreads();
    if (taps <= chunk_taps) {
        stage_tables(s, 0, taps, lo, hi);
    } else if (n_stages > 0) {
        const long long n_idx = static_cast<long long>(s.n_out) * taps;
#pragma unroll 4
        for (long long e = threadIdx.x; e < n_idx; e += THREADS) {
            const int v = __ldg(s.block_idx + e);
            lo = min(lo, v);
            hi = max(hi, v);
        }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xFFFFFFFFu, lo, d));
        hi = max(hi, __shfl_xor_sync(0xFFFFFFFFu, hi, d));
    }
    if ((threadIdx.x & 31) == 0) {
        atomicMin(&s_lo, lo);
        atomicMax(&s_hi, hi);
    }
    __syncthreads();
    const long long reach = (static_cast<long long>(s_hi) - s_lo + 1) * C;
    const bool staged = n_stages > 0 && s_hi >= s_lo && staged_row_bytes(reach) <= seg_stride;
    s.lo = staged ? s_lo : 0;
    s.seg_bytes = staged ? static_cast<int>(reach) : 0;
    if (staged) {
        walk_strip<C, true>(s);
    } else {
        walk_strip<C, false>(s);
    }
}

template <int C>
cudaError_t launch_cols(const uint8_t* src, uint8_t* dst, const int* idx, const double* w,
                        long long rows, long long cols, long long out_size, int taps,
                        int device, cudaStream_t stream) {
    // THREADS neighbouring outputs reach about THREADS / scale source columns
    // and one row of taps more; the kernel checks what its tables really
    // reach. As many steps are staged as fit, at least two.
    const int chunk_taps = taps < TAPS ? taps : TAPS;
    long long seg_px = static_cast<long long>((THREADS - 1.0) * cols / out_size) + taps + 4;
    if (seg_px > cols) seg_px = cols;
    const long long seg_stride = staged_row_bytes(seg_px * C);
    // Steps ahead until a block has IN_FLIGHT_BYTES on their way: beyond that,
    // shared memory is better spent on more resident blocks.
    long long n_stages = (SMEM_MAX_BYTES - table_bytes(chunk_taps)) / (ROWS * seg_stride);
    const long long wanted = 1 + (IN_FLIGHT_BYTES + ROWS * seg_stride - 1) / (ROWS * seg_stride);
    if (n_stages > wanted) n_stages = wanted;
    if (n_stages > MAX_STAGES) n_stages = MAX_STAGES;
    if (n_stages < 2) n_stages = 0;
    const size_t smem =
        static_cast<size_t>(table_bytes(chunk_taps) + n_stages * ROWS * seg_stride);
    const auto kernel = pass_cols_kernel<C>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(SMEM_MAX_BYTES));
    // One wave of resident blocks: each walks a strip of rows.
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    }
    if (err != cudaSuccess) return err;
    const long long blocks_x = (out_size + THREADS - 1) / THREADS;
    const long long steps = (rows + ROWS - 1) / ROWS;
    const long long resident = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
    long long strips = (resident + blocks_x - 1) / blocks_x;
    if (strips > steps) strips = steps;
    const long long strip_rows = (steps + strips - 1) / strips * ROWS;
    strips = (rows + strip_rows - 1) / strip_rows;
    if (blocks_x * strips > INT_MAX) return cudaErrorInvalidConfiguration;
    // The kernel stages rows from their aligned chunks by itself.
    return ipt::launch(kernel, static_cast<unsigned>(blocks_x * strips), THREADS, smem, stream, {},
                       src, dst, idx, w, rows, cols, out_size, taps, blocks_x, strip_rows,
                       chunk_taps, static_cast<int>(seg_stride), static_cast<int>(n_stages));
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
        const long long all = n * rows;
        err = channels == 3 ? launch_cols<3>(s, d, i, wt, all, cols, out_size, taps, device, st)
                            : launch_cols<1>(s, d, i, wt, all, cols, out_size, taps, device, st);
        return static_cast<int>(err);
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
