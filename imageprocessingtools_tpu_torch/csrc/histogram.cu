// K4: the exact 256-bin histogram of n uint8 values -> int32[256].
//
// Replaces the Pallas kernel
//   imageprocessingtools_tpu/kernels/pallas_core.py::histogram_pallas
// (body _hist_kernel, with _hist_slab_counts and _fold_diag_blocks). The TPU
// has no fast scatter, so that kernel expanded 8-row slabs, one-hot encoded
// the nibbles and contracted them on the matrix unit, carried the counts
// across sequential grid steps, padded lanes to 128 and corrected bin 0 for
// the padding. Hopper has shared-memory atomics, and they are the design.
//
// What bounds it on an H100: bytes (8.3 MB read at 4K, 2.5 us). What held the
// first design (at most 1024 blocks of 256 threads, a block-private int[256],
// one global atomicAdd per non-empty bin per block into an output the wrapper
// zeroed) at 11.8 us on 4K noise was that flush: 262,144 global atomics onto
// 256 addresses, 6.8 us of it (NVIDIA H100 80GB HBM3 at 700 W; the cuts and
// every variant that was timed are in PERF.md). The bank conflicts of its
// shared atomics cost about 0.4 us, and threads adding to one bin are merged
// by the hardware, so noise and a gradient, not the constant image (3.4 us),
// were its slow cases. This design:
//
// - One resident block of 1024 threads per SM walks its share of the buffer,
//   each thread counting one 16-byte load while its next is in flight, so the
//   flush runs 132 times, not 1024.
// - Counting without bank conflicts: bin b of lane l lives at word 32 b + l
//   of an int[256][32], so lane l only touches bank l and every shared
//   atomic of a warp takes one pass. Sixteen equal bytes of one load (a flat
//   region, a constant image) are counted by one atomic. The counters are
//   int32 and a block sees fewer than 2^31 bytes, so nothing folds on the way.
// - The bytes before the first 16-byte boundary and after the last are
//   counted one by one by block 0, so an unaligned view runs at the aligned
//   rate.
// - The flush needs no zeroed output, no fence and no second pass: a block
//   "arrives" on a 64-bit scratch word per bin with one global atomicAdd of
//   its count in the low word and 1 in the high word. The arrival whose
//   atomic returns all the others' is the last: the returned low word plus
//   its own count is the total, and it zeroes the word for the next call.
//   The total travels in the atomic's own word, so no ordering between
//   addresses is needed. Atomics on one address run one after another (on
//   that card 132 took 0.8 us), so the blocks arrive in GROUPS groups on the
//   groups' words, and each group's last arrival hands the group's total in
//   on the top words, whose last arrival stores the bin to the output. The
//   scratch words belong to one (device, stream): calls on one stream run
//   in turn, calls on different streams use different words. A launch
//   captured into a CUDA graph is given words of its own by the caller
//   (zeroed in the graph before it), so no two graphs, and no graph and an
//   eager call, share words, whichever streams they run on.
//
// Integer sums are order-free, so the result is exact for any count below
// 2^31 (the wrapper checks).
//
// The batch axis (the counterpart of jax.vmap of histogram_pallas):
// uint8[N, n] -> int32[N, 256] in one launch, image b on blockIdx.y. Image
// b's blocks count only its bytes (its own head and tail included), flush
// into hist[b] and arrive on arrival words of its own (ARRIVAL_WORDS of them
// at arrivals + b ARRIVAL_WORDS, which the caller gives zeroed and the
// launch leaves zero), so counts never mix images. The blocks per image are
// the card's SMs over N (at least one), so a batch takes about one block per
// SM as one image does. A single image is launched without the batch
// offsets (histogram_kernel<false>).

#include <cstdint>
#include <cuda_runtime.h>
#include <map>
#include <mutex>
#include <utility>

#include "launch.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int GROUPS = 12;  // about the square root of the blocks
constexpr int ARRIVAL_WORDS = 256 * (GROUPS + 1);

// Adds `weight` to bin b's counter of this lane (lane4 = 4 * lane).
__device__ __forceinline__ void count(int* counts, uint32_t b, uint32_t lane4, int weight) {
    atomicAdd(reinterpret_cast<int*>(reinterpret_cast<char*>(counts) + ((b << 7) | lane4)), weight);
}

__device__ __forceinline__ void count16(int* counts, const uint4& v, uint32_t lane4) {
    if (v.x == v.y && v.x == v.z && v.x == v.w && v.x == __byte_perm(v.x, 0, 0)) {
        count(counts, v.x & 0xFF, lane4, 16);
        return;
    }
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) count(counts, (w[j] >> (8 * i)) & 0xFF, lane4, 1);
    }
}

// Arrives with `sum` on `word`. True for the last of `of` arrivals, which
// gets the total in `sum` and leaves the word zero.
__device__ __forceinline__ bool arrive(unsigned long long* word, unsigned of, int& sum) {
    const unsigned long long old = atomicAdd(word, (1ull << 32) | static_cast<uint32_t>(sum));
    if ((old >> 32) != of - 1) return false;
    sum += static_cast<int>(static_cast<uint32_t>(old));
    *word = 0;
    return true;
}

// kBatch: image blockIdx.y of the batch (values + n blockIdx.y, its own
// histogram and arrival words); a single image is compiled without those
// offsets. gridDim.x blocks an image.
template <bool kBatch>
__global__ void __launch_bounds__(THREADS)
histogram_kernel(const uint8_t* __restrict__ values, int* __restrict__ hist,
                 unsigned long long* __restrict__ arrivals, long long n) {
    __shared__ __align__(16) int counts[256 * 32];
    if constexpr (kBatch) {
        values += n * blockIdx.y;
        hist += 256 * blockIdx.y;
        arrivals += static_cast<size_t>(ARRIVAL_WORDS) * blockIdx.y;
    }

    // The bytes before the first 16-byte boundary (head) and after the last
    // (tail), and the n_vec 16-byte words between (n < 2^31, so ints do).
    const int head = static_cast<int>(min(n, static_cast<long long>(-reinterpret_cast<uintptr_t>(values) & 15)));
    const int n_vec = static_cast<int>((n - head) / 16);
    const int tail = static_cast<int>(n - head) - 16 * n_vec;
    const uint4* v4 = reinterpret_cast<const uint4*>(values + head);
    const int stride = gridDim.x * THREADS;

    // The first load flies while the counters are zeroed.
    int i = blockIdx.x * THREADS + threadIdx.x;
    uint4 v = make_uint4(0, 0, 0, 0), next = v;
    if (i < n_vec) v = __ldg(v4 + i);
    for (int k = threadIdx.x; k < 256 * 32 / 4; k += THREADS) {
        reinterpret_cast<uint4*>(counts)[k] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();

    const uint32_t lane4 = 4 * (threadIdx.x % 32);
    if (blockIdx.x == 0) {
        if (threadIdx.x < head) count(counts, values[threadIdx.x], lane4, 1);
        if (threadIdx.x < tail) count(counts, values[n - tail + threadIdx.x], lane4, 1);
    }
    for (; i < n_vec; i += stride) {
        if (i + stride < n_vec) next = __ldg(v4 + i + stride);
        count16(counts, v, lane4);
        v = next;
    }
    __syncthreads();

    // Thread b < 256 sums bin b's 32 counters (starting at its own bank) and
    // arrives with the sum: block i in group i % groups, then the group's
    // last arrival on the top words.
    const int b = threadIdx.x;
    if (b >= 256) return;
    int sum = 0;
#pragma unroll
    for (int l = 0; l < 32; ++l) sum += counts[32 * b + (l + b) % 32];
    const unsigned groups = min(static_cast<unsigned>(GROUPS), gridDim.x);
    const unsigned g = blockIdx.x % groups;
    const unsigned size = (gridDim.x - g + groups - 1) / groups;  // blocks in group g
    if (arrive(&arrivals[256 * (g + 1) + b], size, sum) && arrive(&arrivals[b], groups, sum)) {
        hist[b] = sum;
    }
}

// The arrival words of (device, stream), the top's 256 and each group's: made
// and zeroed (on the stream) at first use and kept; every launch leaves them
// zero again.
unsigned long long* arrival_words(int device, cudaStream_t stream, cudaError_t* err) {
    static std::mutex mutex;
    static std::map<std::pair<int, cudaStream_t>, unsigned long long*> made;
    const std::lock_guard<std::mutex> lock(mutex);
    unsigned long long*& words = made[{device, stream}];
    if (words == nullptr) {
        *err = cudaMalloc(&words, ARRIVAL_WORDS * sizeof(unsigned long long));
        if (*err == cudaSuccess) {
            *err = cudaMemsetAsync(words, 0, ARRIVAL_WORDS * sizeof(unsigned long long), stream);
        }
        if (*err != cudaSuccess) {
            cudaFree(words);
            words = nullptr;
        }
    }
    return words;
}

// N images of n values on `words` (N ARRIVAL_WORDS): the card's SMs over N
// blocks per image (at least 1), each image's count capped at one block per
// 16 KB of its values.
int launch(const void* values, void* hist, int N, long long n, int device, void* stream,
           unsigned long long* words) {
    int sms = 0;
    const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    long long blocks = (n / 16 + THREADS - 1) / THREADS;
    const long long share = sms / N;
    if (blocks > share) blocks = share;
    if (blocks < 1) blocks = 1;
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(N));
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* v = static_cast<const uint8_t*>(values);
    auto* h = static_cast<int*>(hist);
    // The kernel counts an unaligned head by itself: no address chose it.
    return static_cast<int>(N == 1 ? ipt::launch(histogram_kernel<false>, grid, THREADS, 0, s, {},
                                                 v, h, words, n)
                                   : ipt::launch(histogram_kernel<true>, grid, THREADS, 0, s, {},
                                                 v, h, words, n));
}

}  // namespace

// The number of 64-bit arrival words a launch uses (per image, for a batch).
extern "C" int ipt_histogram_arrival_words() { return ARRIVAL_WORDS; }

// values uint8[n] -> hist int32[256] (any contents before: every word is
// stored). `arrivals`: ARRIVAL_WORDS zeroed 64-bit words that this launch
// may use (a launch leaves them zero), or null for the (device, stream)'s
// own, made at its first call; a launch captured into a CUDA graph must be
// given its own, since a capture may not allocate.
extern "C" int ipt_histogram(const void* values, void* hist, long long n, int device,
                             void* stream, void* arrivals) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    auto* words = static_cast<unsigned long long*>(arrivals);
    if (words == nullptr) words = arrival_words(device, static_cast<cudaStream_t>(stream), &err);
    if (words == nullptr) return static_cast<int>(err);
    return launch(values, hist, 1, n, device, stream, words);
}

// values uint8[N, n] -> hist int32[N, 256] (every word stored), in one
// launch. `arrivals`: N ARRIVAL_WORDS zeroed 64-bit words (a launch leaves
// them zero); required.
extern "C" int ipt_histogram_batch(const void* values, void* hist, int N, long long n, int device,
                                   void* stream, void* arrivals) {
    if (arrivals == nullptr || N < 1 || N > 65535) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch(values, hist, N, n, device, stream, static_cast<unsigned long long*>(arrivals));
}
