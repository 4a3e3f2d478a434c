// K4: the exact 256-bin histogram of n uint8 values -> int32[256].
//
// Replaces the Pallas kernel
//   imageprocessingtools_tpu/kernels/pallas_core.py::histogram_pallas
// (body _hist_kernel, with _hist_slab_counts and _fold_diag_blocks). The TPU
// has no fast scatter, so that kernel expanded 8-row slabs, one-hot encoded
// the nibbles and contracted them on the matrix unit, carried the counts
// across sequential grid steps, padded lanes to 128 and corrected bin 0 for
// the padding. Hopper has shared-memory atomics: each block keeps a private
// int[256] in shared memory, counts 16 bytes per thread per step (one
// 16-byte load, grid-stride), and flushes it with one global atomicAdd per
// non-empty bin into an int32[256] that the wrapper zeroes. Integer sums are
// order-free, so the result is exact for any count below 2^31 (the wrapper
// checks). A byte-wise loop takes the tail and unaligned buffers.
//
// What bounds it on an H100: bytes (8.3 MB read at 4K) as long as the bins
// spread. All threads of a block adding to one bin serialise on that shared
// address, so a constant image is the worst case; that case is measured,
// not redesigned, in this first version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 1024;

__device__ __forceinline__ void count_word(uint32_t w, int* shist) {
    atomicAdd(&shist[w & 0xFF], 1);
    atomicAdd(&shist[(w >> 8) & 0xFF], 1);
    atomicAdd(&shist[(w >> 16) & 0xFF], 1);
    atomicAdd(&shist[w >> 24], 1);
}

__global__ void __launch_bounds__(THREADS)
histogram_kernel(const uint8_t* __restrict__ values, int* __restrict__ hist, long long n) {
    __shared__ int shist[256];
    for (int b = threadIdx.x; b < 256; b += THREADS) shist[b] = 0;
    __syncthreads();

    const long long stride = static_cast<long long>(gridDim.x) * THREADS;
    const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
    const bool aligned = reinterpret_cast<uintptr_t>(values) % 16 == 0;
    const long long n_vec = aligned ? n / 16 : 0;
    const uint4* v4 = reinterpret_cast<const uint4*>(values);
    for (long long i = tid; i < n_vec; i += stride) {
        const uint4 v = __ldg(v4 + i);
        count_word(v.x, shist);
        count_word(v.y, shist);
        count_word(v.z, shist);
        count_word(v.w, shist);
    }
    for (long long i = n_vec * 16 + tid; i < n; i += stride) {
        atomicAdd(&shist[values[i]], 1);
    }
    __syncthreads();

    for (int b = threadIdx.x; b < 256; b += THREADS) {
        if (shist[b]) atomicAdd(&hist[b], shist[b]);
    }
}

}  // namespace

extern "C" int ipt_histogram(const void* values, void* hist, long long n, int device,
                             void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    long long blocks = (n / 16 + THREADS - 1) / THREADS;
    if (blocks < 1) blocks = 1;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    histogram_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(values), static_cast<int*>(hist), n);
    return static_cast<int>(cudaGetLastError());
}
