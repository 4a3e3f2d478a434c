// K3: out[i] = lut[values[i]] for uint8 values and a uint8[256] LUT.
//
// Replaces the Pallas kernel
//   imageprocessingtools_tpu/kernels/pallas_core.py::lut_apply_pallas
// (body _lut_kernel). The TPU has no fast gather, so that kernel expanded
// 8-row slabs, one-hot encoded the nibbles and contracted them with a
// block-diagonal LUT on the matrix unit. Hopper gathers from shared memory
// directly: each block copies the 256-byte LUT into shared memory and each
// thread maps 16 bytes at a time (one 16-byte load and store) by direct
// index; a byte-wise loop takes the tail and unaligned buffers.
//
// What bounds it on an H100: bytes (1 read and 1 written per pixel, 8.3 MB
// each way at 4K). Shared-memory LUT reads are byte-indexed and may conflict
// on banks for skewed images; the vector loads keep global traffic coalesced.
//
// The batch axis (the counterpart of jax.vmap of lut_apply_pallas): values
// uint8[N, n] through luts uint8[N, 256] in one launch, image b on
// blockIdx.y with LUT b in its blocks' shared memory. Each image's bytes are
// mapped on their own, as a single image's are: in 16-byte words where its
// input and output start on 16-byte boundaries (with n % 16 == 0 every
// image does when the first does), else byte by byte, so no word straddles
// two images whatever n % 16 is. A single image is the batch of one.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t map_word(uint32_t w, const uint8_t* lut) {
    return static_cast<uint32_t>(lut[w & 0xFF]) |
           (static_cast<uint32_t>(lut[(w >> 8) & 0xFF]) << 8) |
           (static_cast<uint32_t>(lut[(w >> 16) & 0xFF]) << 16) |
           (static_cast<uint32_t>(lut[w >> 24]) << 24);
}

// Image blockIdx.y: values and out + n blockIdx.y, luts + 256 blockIdx.y.
__global__ void __launch_bounds__(THREADS)
lut_apply_kernel(const uint8_t* __restrict__ batch, uint8_t* __restrict__ batch_out,
                 const uint8_t* __restrict__ luts, long long n) {
    __shared__ uint8_t slut[256];
    const uint8_t* __restrict__ values = batch + n * blockIdx.y;
    uint8_t* __restrict__ out = batch_out + n * blockIdx.y;
    for (int i = threadIdx.x; i < 256; i += THREADS) slut[i] = luts[256 * blockIdx.y + i];
    __syncthreads();

    const long long stride = static_cast<long long>(gridDim.x) * THREADS;
    const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
    const bool aligned = (reinterpret_cast<uintptr_t>(values) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    const long long n_vec = aligned ? n / 16 : 0;
    const uint4* v4 = reinterpret_cast<const uint4*>(values);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (long long i = tid; i < n_vec; i += stride) {
        uint4 v = __ldg(v4 + i);
        v.x = map_word(v.x, slut);
        v.y = map_word(v.y, slut);
        v.z = map_word(v.z, slut);
        v.w = map_word(v.w, slut);
        o4[i] = v;
    }
    for (long long i = n_vec * 16 + tid; i < n; i += stride) {
        out[i] = slut[values[i]];
    }
}

// N images of n values: one 16-byte word per thread, at most 65535 blocks an
// image (a grid-stride loop covers the rest).
int launch(const void* values, void* out, const void* luts, int N, long long n, int device,
           void* stream) {
    if (N < 1 || N > 65535) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    long long blocks = (n / 16 + THREADS - 1) / THREADS;
    if (blocks < 1) blocks = 1;
    if (blocks > 65535) blocks = 65535;
    // The kernel picks its words by each image's addresses itself.
    return static_cast<int>(ipt::launch(
        lut_apply_kernel, dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(N)), THREADS,
        0, static_cast<cudaStream_t>(stream), {}, static_cast<const uint8_t*>(values),
        static_cast<uint8_t*>(out), static_cast<const uint8_t*>(luts), n));
}

}  // namespace

extern "C" int ipt_lut_apply(const void* values, void* out, const void* lut, long long n,
                             int device, void* stream) {
    return launch(values, out, lut, 1, n, device, stream);
}

// values uint8[N, n] -> out uint8[N, n], image b through luts[b] (uint8[N,
// 256]), in one launch.
extern "C" int ipt_lut_apply_batch(const void* values, void* out, const void* luts, int N,
                                   long long n, int device, void* stream) {
    return launch(values, out, luts, N, n, device, stream);
}
