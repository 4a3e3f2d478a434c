// K1: arbitrary-angle clockwise rotation, byte-identical to the C reference.
//
// Replaces the Pallas kernel
//   imageprocessingtools_tpu/kernels/pallas_rotate.py::rotate_blocked_pallas
// (body _make_kernel, launch _build_call). That kernel worked around the
// TPU's missing f64 and gather (double-f32 geometry, int8 MXU weight splits,
// per-tile DMA blocks) and carried a +-1 budget in the interior. Hopper has
// both, so this kernel computes the reference's own arithmetic
// (ppmx-edward.c:727-785, golden/model.py:92-136) directly: each output pixel
// is inverse-mapped about the integer centres; outside the source -> 0, edge
// band -> nearest, interior (round(n) in (1, dim-2)) -> 4x4 Keys a=-0.5
// bicubic, clamp, truncate. Every f64 operation is an explicit
// __dmul_rn/__dadd_rn/__dsub_rn in the order of ops/_exact.py:258-290 and
// golden/model.py:119-135: nvcc would otherwise contract a*b+c into an FMA,
// and one FMA changes a truncated byte. cos and sin come from the host
// (glibc's values, as the reference and _exact.plan_rotation use) because
// device cos/sin may differ in the last ulp.
//
// What bounds it on an H100: f64 operations. None may be fused, so each one
// takes a whole FP64 issue slot: 132 SMs x 64 lanes x ~1.98 GHz ~ 16.7 T op/s,
// half the data sheet's 34 TFLOP/s, which counts an FMA as two. An interior
// RGB pixel needs 173 of them (4 for its source position, per axis 4
// offsets and 28 for the Keys weights, 35 per channel of taps), so a 4K
// 30-degree rotation needs ~1.4 G, ~85 us (chip_smoke.py::rotate_cost
// counts them). The design keeps the f64 pipe fed:
//
// - one block of 128 threads per 32x32 output tile, six blocks to an SM;
//   the host plans each tile (class and source footprint,
//   kernels/rotate.py::tile_plan). An outside tile only writes zeros; an
//   interior tile skips the zone tests;
// - the tile's source footprint (its corners' inverse map, plus the 4x4 tap
//   reach and a margin) is copied into shared memory as the image's aligned
//   16-byte chunks, every copy of the block in flight at once (cp.async);
// - a tap row is C + 1 aligned 4-byte shared loads and C funnel shifts for
//   its 4 C bytes (a footprint kept as f64 would move 8x the shared-memory
//   bytes per tap), and each byte becomes f64 with the exact 2^52 trick (a
//   byte move and one DADD) instead of an int->f64 conversion, which issues
//   at a quarter of the f64 rate;
// - the products cos*xs and -sin*xs are computed once per column (a thread
//   keeps its column) and sin*ys and cos*ys once per tile row, in shared
//   memory: the C rounds each product before adding, so this gives its bits;
// - the Keys weights take their branch per tap, not per value: with
//   f = n - floor(n), the four arguments are 1+f, f, f-1 and f-2 (outer,
//   inner, inner, outer; at |t| = 1 both branches give +0.0), computed
//   exactly from n - floor(n);
// - the three channels' sums run interleaved, and the first product of each
//   sum is taken as the sum (0 + x = x; only the sign of a zero sum could
//   differ, and it truncates to the same byte);
// - the tile's bytes leave through shared memory as 16-byte stores; each
//   row's unaligned head and tail go as naturally aligned 1-8 byte pieces;
// - a launch may take one band of output rows (32-row tiles) from a window
//   of source rows, for the row bands of parallel/spatial.py: only the
//   staging's addresses move, so the whole image is the band of all rows;
// - a batch of N images of one shape (jax.vmap's one op over the batch:
//   imageprocessingtools_tpu/serving.py::_jitted_local_vmap, whose rotation
//   is the XLA form under a tracer) is one launch, image blockIdx.z (so N is
//   at most 65535), its source and output a whole image apart (64-bit
//   offsets). All images share the geometry, so they share the plan and the
//   shared-memory box. A single image and a band run the kBatch = false
//   instance, which has no batch offset.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int TILE = 32;      // output tile side, pixels
constexpr int BX = 32;        // threads per block: one warp per tile row ...
constexpr int BY = 4;         // ... and 4 rows of threads, 8 tile rows each
constexpr int THREADS = BX * BY;
// Tile classes, as kernels/rotate.py::tile_plan writes them.
constexpr int OUTSIDE = 0;
constexpr int INTERIOR = 1;

__device__ __forceinline__ double byte_to_double(uint32_t b) {
    // (2^52 + b) - 2^52: exact, and one DADD instead of a conversion.
    return __dsub_rn(__hiloint2double(0x43300000, static_cast<int>(b)), 4503599627370496.0);
}

// Keys a=-0.5 in the expression order of ppmx-edward.c:477-489 /
// ops/_exact.py::cubic, split by branch: inner is |t| <= 1, outer 1 < |t| <= 2.
__device__ __forceinline__ double cubic_inner(double t) {
    const double a = fabs(t);
    const double a2 = __dmul_rn(a, a);
    const double a3 = __dmul_rn(a2, a);
    return __dadd_rn(__dsub_rn(__dmul_rn(1.5, a3), __dmul_rn(2.5, a2)), 1.0);
}

__device__ __forceinline__ double cubic_outer(double t) {
    const double a = fabs(t);
    const double a2 = __dmul_rn(a, a);
    const double a3 = __dmul_rn(a2, a);
    return __dadd_rn(
        __dsub_rn(__dadd_rn(__dmul_rn(-0.5, a3), __dmul_rn(2.5, a2)), __dmul_rn(4.0, a)), 2.0);
}

// Weights of the taps floor(n) - 1 + k, k = 0..3: cubic(n - (floor(n) - 1 + k)).
// With t = n - floor(n), each argument t + 1, t, t - 1, t - 2 is exact (n is
// within 3 of the integer), so it equals the C's n - (bx + k) bit for bit.
__device__ __forceinline__ void keys_weights(double n, double fl, double* w) {
    const double t = __dsub_rn(n, fl);
    w[0] = cubic_outer(__dadd_rn(t, 1.0));
    w[1] = cubic_inner(t);
    w[2] = cubic_inner(__dsub_rn(t, 1.0));
    w[3] = cubic_outer(__dsub_rn(t, 2.0));
}

// One output pixel from the block's footprint bytes into o[0..C). Footprint
// row r holds the image's bytes from the 16-byte word below its first byte:
// pixel (r, j) channel c is raw[r * stride + shift[r] + j * C + c].
template <int C, bool kChecked>
__device__ __forceinline__ void pixel(double nX, double nY, const uint8_t* raw, int stride,
                                      const int* shift, int lo_x, int lo_y, int H, int W,
                                      uint8_t* o) {
    if (kChecked) {
        const double rX = floor(__dadd_rn(nX, 0.5));
        const double rY = floor(__dadd_rn(nY, 0.5));
        if (!(rX < W && rY < H && rY >= 0.0 && rX >= 0.0)) {
#pragma unroll
            for (int c = 0; c < C; ++c) o[c] = 0;
            return;
        }
        if (!(rX > 1.0 && rY > 1.0 && rX < static_cast<double>(max(W - 2, 0)) &&
              rY < static_cast<double>(max(H - 2, 0)))) {
            const int r = static_cast<int>(rY) - lo_y;
            const uint8_t* v = raw + r * stride + shift[r] + (static_cast<int>(rX) - lo_x) * C;
#pragma unroll
            for (int c = 0; c < C; ++c) o[c] = v[c];
            return;
        }
    }
    const double fy = floor(nY);
    const double fx = floor(nX);
    double wy[4], wx[4];
    keys_weights(nY, fy, wy);
    keys_weights(nX, fx, wx);
    const int ty = static_cast<int>(fy) - 1 - lo_y;
    const int tx = (static_cast<int>(fx) - 1 - lo_x) * C;
    double acc[C];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        // The row's 4 C tap bytes from C + 1 aligned words and C funnel shifts.
        const int at = (ty + j) * stride + shift[ty + j] + tx;
        const uint32_t* wp = reinterpret_cast<const uint32_t*>(raw + (at & ~3));
        const uint32_t sh = 8 * (at & 3);
        uint32_t taps[C];
#pragma unroll
        for (int k = 0; k < C; ++k) taps[k] = __funnelshift_r(wp[k], wp[k + 1], sh);
        double p[C];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int b = i * C + c;
                const double v = byte_to_double(__byte_perm(taps[b / 4], 0, 0x4440 | (b % 4)));
                const double prod = __dmul_rn(v, wx[i]);
                p[c] = i == 0 ? prod : __dadd_rn(p[c], prod);
            }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const double t = __dmul_rn(p[c], wy[j]);
            acc[c] = j == 0 ? t : __dadd_rn(acc[c], t);
        }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
        double a = acc[c];
        if (a < 0.0) a = 0.0;
        if (a >= 256.0) a = 255.0;
        o[c] = static_cast<uint8_t>(static_cast<int>(a));  // (int) truncates
    }
}

// Shared-memory layout of a block: the footprint's rows (raw_stride bytes
// each, 16 bytes of slack after the last), the tile's output bytes (OUT_W a
// row) and each footprint row's shift.
__host__ __device__ constexpr int raw_stride(int box_w, int C) {
    return (box_w * C + 15 + 15 + 15) / 16 * 16;  // head shift, the bytes, the tail chunk
}

__host__ __device__ constexpr int out_stride(int C) { return (TILE * C + 15 + 15) / 16 * 16; }

__host__ __device__ constexpr size_t raw_bytes(int box_w, int box_h, int C) {
    return static_cast<size_t>(box_h) * raw_stride(box_w, C) + 16;
}

__host__ __device__ constexpr size_t smem_bytes(int box_w, int box_h, int C) {
    return raw_bytes(box_w, box_h, C) + TILE * out_stride(C) + (4 * box_h + 15) / 16 * 16;
}

// Bytes [lo, hi) of the 16-byte-aligned chunk a, from the chunk s (or
// zeros) at the same alignment, as naturally aligned 1, 2, 4 and 8-byte
// stores: at most eight, where single bytes would take up to fifteen. A
// tile's row rarely starts or ends on a 16-byte boundary, and these partial
// chunks' byte stores took a third of the kernel's time.
__device__ __forceinline__ void store_part(uint8_t* a, const uint8_t* s, int lo, int hi,
                                           bool zero) {
    int k = lo;
#pragma unroll
    for (int n = 1; n <= 8; n *= 2) {  // up to the first 16-byte-aligned piece
        if ((k & n) && k + n <= hi) {
            if (n == 1) a[k] = zero ? 0 : s[k];
            if (n == 2) *reinterpret_cast<uint16_t*>(a + k) = zero ? 0 : *reinterpret_cast<const uint16_t*>(s + k);
            if (n == 4) *reinterpret_cast<uint32_t*>(a + k) = zero ? 0 : *reinterpret_cast<const uint32_t*>(s + k);
            if (n == 8) *reinterpret_cast<uint64_t*>(a + k) = zero ? 0 : *reinterpret_cast<const uint64_t*>(s + k);
            k += n;
        }
    }
#pragma unroll
    for (int n = 8; n >= 1; n /= 2) {  // then down to the last byte
        if (k + n <= hi) {
            if (n == 1) a[k] = zero ? 0 : s[k];
            if (n == 2) *reinterpret_cast<uint16_t*>(a + k) = zero ? 0 : *reinterpret_cast<const uint16_t*>(s + k);
            if (n == 4) *reinterpret_cast<uint32_t*>(a + k) = zero ? 0 : *reinterpret_cast<const uint32_t*>(s + k);
            if (n == 8) *reinterpret_cast<uint64_t*>(a + k) = zero ? 0 : *reinterpret_cast<const uint64_t*>(s + k);
            k += n;
        }
    }
}

// plan[tile] = {class, lo_x, lo_y, bw | bh << 16}: the tile's class and its
// source footprint [lo_y, lo_y + bh) x [lo_x, lo_x + bw) (kernels/rotate.py);
// box_w x box_h is the largest footprint of the launch. kBatch: image
// blockIdx.z of a batch of whole images (src_row0 0, src_rows H).
template <int C, bool kBatch>
__global__ void __launch_bounds__(THREADS, 6)
rotate_kernel(const uint8_t* __restrict__ src, int src_row0, int src_rows,
              uint8_t* __restrict__ dst, int H, int W, int newH, int newW, double cos_t,
              double sin_t, int xc, int yc, int xoff, int yoff, const int4* __restrict__ plan,
              int box_w, int box_h) {
    if constexpr (kBatch) {
        src += static_cast<size_t>(blockIdx.z) * src_rows * W * C;
        dst += static_cast<size_t>(blockIdx.z) * newH * newW * C;
    }
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ double row_sin[TILE], row_cos[TILE];  // sin*ys, cos*ys per tile row
    constexpr int OUT_W = out_stride(C);
    const int stride = raw_stride(box_w, C);
    uint8_t* raw = smem;
    uint8_t* staged = smem + raw_bytes(box_w, box_h, C);
    int* shift = reinterpret_cast<int*>(staged + TILE * OUT_W);

    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BX + tx;
    const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
    const int rows = min(TILE, newH - y0), cols = min(TILE, newW - x0);
    const int4 p = plan[blockIdx.y * gridDim.x + blockIdx.x];

    if (p.x != OUTSIDE) {
        const int lo_x = p.y, lo_y = p.z, bw = p.w & 0xFFFF, bh = p.w >> 16;
        // The footprint's rows as aligned 16-byte chunks, all copies in
        // flight at once (cp.async); a chunk that reaches past either end of
        // the source window is copied byte by byte.
        const uint8_t* end = src + static_cast<size_t>(src_rows) * W * C;
        for (int r = ty; r < bh; r += BY) {
            const uint8_t* g = src + (static_cast<size_t>(lo_y - src_row0 + r) * W + lo_x) * C;
            const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
            const uint8_t* a = g - sh;
            const int chunks = (sh + bw * C + 15) / 16;
            if (tx == 0) shift[r] = sh;
            for (int k = tx; k < chunks; k += BX) {
                const uint8_t* from = a + 16 * k;
                uint8_t* to = raw + r * stride + 16 * k;
                if (from >= src && from + 16 <= end) {
                    __pipeline_memcpy_async(to, from, 16);
                } else {
                    for (int b = 0; b < 16; ++b) {
                        if (from + b >= src && from + b < end) to[b] = from[b];
                    }
                }
            }
        }
        __pipeline_commit();
        if (tid < TILE) {
            const double ys = static_cast<double>(y0 + tid - yoff - yc);  // exact
            row_sin[tid] = __dmul_rn(sin_t, ys);
            row_cos[tid] = __dmul_rn(cos_t, ys);
        }
        // (x - x_offset) - x_center: a small integer, exact in f64.
        const double xs = static_cast<double>(x0 + tx - xoff - xc);
        const double col_cos = __dmul_rn(cos_t, xs);
        const double col_msin = __dmul_rn(-sin_t, xs);
        __pipeline_wait_prior(0);
        __syncthreads();

        if (tx < cols) {
#pragma unroll 1
            for (int r = ty; r < rows; r += BY) {
                const double nX = __dadd_rn(__dadd_rn(col_cos, row_sin[r]), static_cast<double>(xc));
                const double nY = __dadd_rn(__dadd_rn(col_msin, row_cos[r]), static_cast<double>(yc));
                const int sh = static_cast<int>(
                    reinterpret_cast<uintptr_t>(dst + (static_cast<size_t>(y0 + r) * newW + x0) * C) & 15);
                uint8_t* o = staged + r * OUT_W + sh + tx * C;
                if (p.x == INTERIOR) {
                    pixel<C, false>(nX, nY, raw, stride, shift, lo_x, lo_y, H, W, o);
                } else {
                    pixel<C, true>(nX, nY, raw, stride, shift, lo_x, lo_y, H, W, o);
                }
            }
        }
        __syncthreads();
    }

    // Store: 8 threads per tile row, 16 bytes each. Output byte k of tile
    // row r (staged[r * OUT_W + k]) goes to the 16-byte-aligned address
    // a + k, where the row's bytes start at a + shift; an outside tile
    // stores zeros without staging.
    const int k0 = 16 * (tid & 7);
    for (int r = tid >> 3; r < rows; r += THREADS / 8) {
        uint8_t* row = dst + (static_cast<size_t>(y0 + r) * newW + x0) * C;
        const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
        uint8_t* a = row - sh + k0;
        const uint8_t* out = staged + r * OUT_W + k0;
        const int lo = max(sh - k0, 0), hi = min(sh + cols * C - k0, 16);
        if (lo == 0 && hi == 16) {
            *reinterpret_cast<uint4*>(a) = p.x == OUTSIDE ? make_uint4(0, 0, 0, 0)
                                                          : *reinterpret_cast<const uint4*>(out);
        } else if (lo < hi) {
            store_part(a, out, lo, hi, p.x == OUTSIDE);
        }
    }
}

// n images (n > 1: the kBatch instance, image on grid.z).
template <int C>
cudaError_t launch(const uint8_t* src, int src_row0, int src_rows, uint8_t* dst, int H, int W,
                   int newH, int newW, double cos_t, double sin_t, int xc, int yc, int xoff,
                   int yoff, const int4* plan, int box_w, int box_h, int n, cudaStream_t stream) {
    if (n < 1 || n > 65535) return cudaErrorInvalidValue;
    const size_t smem = smem_bytes(box_w, box_h, C);
    const auto kernel = n > 1 ? rotate_kernel<C, true> : rotate_kernel<C, false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((newW + TILE - 1) / TILE, (newH + TILE - 1) / TILE, n);
    // The kernel reads and writes by its rows' aligned chunks by itself.
    return ipt::launch(kernel, grid, dim3(BX, BY), smem, stream, {}, src, src_row0, src_rows, dst,
                       H, W, newH, newW, cos_t, sin_t, xc, yc, xoff, yoff, plan, box_w, box_h);
}

int rotate(const void* src, int src_row0, int src_rows, void* dst, int H, int W, int C, int newH,
           int newW, double cos_t, double sin_t, int xc, int yc, int xoff, int yoff,
           const void* plan, int box_w, int box_h, int n, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto* s = static_cast<const uint8_t*>(src);
    auto* d = static_cast<uint8_t*>(dst);
    const auto* p = static_cast<const int4*>(plan);
    const auto st = static_cast<cudaStream_t>(stream);
    if (C == 3) {
        err = launch<3>(s, src_row0, src_rows, d, H, W, newH, newW, cos_t, sin_t, xc, yc, xoff,
                        yoff, p, box_w, box_h, n, st);
    } else if (C == 1) {
        err = launch<1>(s, src_row0, src_rows, d, H, W, newH, newW, cos_t, sin_t, xc, yc, xoff,
                        yoff, p, box_w, box_h, n, st);
    } else {
        err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}

}  // namespace

// C is 1 or 3 (the wrapper refuses others). The launch computes output rows
// [oy0, oy0 + newH) of the rotation of an H x W x C image, oy0 a multiple of
// 32, into dst; the caller passes yoff - oy0 for yoff and the plan from tile
// row oy0 / 32 on (an integer offset is exact in f64, so each row's ys is
// the full image's). src holds source rows [src_row0, src_row0 + src_rows),
// which must hold the footprint of every tile of the band that is not
// outside (kernels/rotate.py::band_window). The zone tests take the whole
// image's H and W. plan: int32[tiles][4] for the ceil(newH / 32) x
// ceil(newW / 32) output tiles (see rotate_kernel); box_w x box_h: the
// largest footprint in the plan. The whole image is oy0 0 with the window
// of all its rows.
extern "C" int ipt_rotate(const void* src, int src_row0, int src_rows, void* dst, int H, int W,
                          int C, int newH, int newW, double cos_t, double sin_t,
                          int xc, int yc, int xoff, int yoff,
                          const void* plan, int box_w, int box_h,
                          int device, void* stream) {
    return rotate(src, src_row0, src_rows, dst, H, W, C, newH, newW, cos_t, sin_t, xc, yc, xoff,
                  yoff, plan, box_w, box_h, 1, device, stream);
}

// The rotation of each of n whole images (1 <= n <= 65535) of one shape,
// one after another in src uint8[n, H, W, C] and dst uint8[n, newH, newW, C],
// in one launch with the plan of the whole image (as ipt_rotate's with
// src_row0 0, src_rows H and oy0 0).
extern "C" int ipt_rotate_batch(const void* src, void* dst, int n, int H, int W, int C,
                                int newH, int newW, double cos_t, double sin_t, int xc, int yc,
                                int xoff, int yoff, const void* plan, int box_w, int box_h,
                                int device, void* stream) {
    return rotate(src, 0, H, dst, H, W, C, newH, newW, cos_t, sin_t, xc, yc, xoff, yoff, plan,
                  box_w, box_h, n, device, stream);
}
