// K4's design space, for timing only: the 256-bin histogram with its
// counting layout, its flush, its block size and its grid as template
// parameters, so that histogram_variants.py can time each combination on one
// card in one process. Not part of the kernel library (kernels/_build.py
// compiles csrc/*.cu only); csrc/histogram.cu holds the design that was kept.
//
// Counting layouts (shared memory of one block):
//   BLOCK_ATOMS   int[256], one shared atomic per byte (the first design);
//   BLOCK_STORES  the same with a plain read-modify-write in place of the
//                 atomic: a cut, its counts are wrong;
//   LANE32        int[256][32], bin b of lane l at word 32 b + l: lane l only
//                 touches bank l, so no atomic of a warp meets a bank conflict;
//   LANE16        the same with two bins to a word in 16-bit halves;
//   WARP16        a 16-bit int[128] sub-histogram per warp.
// The 16-bit layouts are not folded on the way, so they hold for up to 65,535
// bytes per counter (any 4K input here).
// Flushes:
//   GLOBAL_ATOMS  one global atomicAdd per non-empty bin per block into an
//                 output the caller zeroed (the first design);
//   NO_FLUSH      nothing is written: a cut;
//   ROWS_TICKET   each block writes its 256 sums to its own row of a scratch;
//                 the last block to finish (a ticket counter) folds the rows
//                 into the output with plain stores and resets the ticket;
//   ACC_TICKET    global atomics into a scratch accumulator that is zero
//                 between calls; the last block copies it to the output and
//                 zeroes it and the ticket again;
//   PACKED64      one 64-bit global atomicAdd per bin per block into a scratch
//                 that is zero between calls: the block's count in the low
//                 word and one arrival in the high word. The block whose
//                 atomic returns gridDim.x - 1 arrivals is the bin's last: it
//                 stores the bin's total and zeroes the scratch word. No
//                 fence, no ticket, no second pass.
// kRuns: 1: sixteen equal bytes of one load are counted by one atomic; 2:
// also four equal bytes of one word.
// kResident: blocks-per-SM x SMs blocks (occupancy API) walk the buffer, four
// 16-byte loads in flight per thread; else at most 1024 blocks (the first
// design's launch).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum { BLOCK_ATOMS, BLOCK_STORES, LANE32, LANE16, WARP16 };
enum { GLOBAL_ATOMS, NO_FLUSH, ROWS_TICKET, ACC_TICKET, PACKED64 };

template <int kCount, int kThreads>
__host__ __device__ constexpr int words() {
    return kCount == LANE32 ? 256 * 32 : kCount == LANE16 ? 128 * 32
         : kCount == WARP16 ? 128 * (kThreads / 32) : 256;
}

template <int kCount>
__device__ __forceinline__ void count(int* s, uint32_t b, int weight) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    if (kCount == BLOCK_ATOMS) atomicAdd(&s[b], weight);
    if (kCount == BLOCK_STORES) reinterpret_cast<volatile int*>(s)[b] += weight;
    if (kCount == LANE32) atomicAdd(&s[32 * b + lane], weight);
    if (kCount == LANE16) atomicAdd(&s[32 * (b >> 1) + lane], weight << (16 * (b & 1)));
    if (kCount == WARP16) atomicAdd(&s[128 * warp + (b >> 1)], weight << (16 * (b & 1)));
}

// The block's count of bin b.
template <int kCount, int kThreads>
__device__ __forceinline__ int total(const int* s, int b) {
    int sum = 0;
    if (kCount == BLOCK_ATOMS || kCount == BLOCK_STORES) sum = s[b];
    if (kCount == LANE32) {
        for (int l = 0; l < 32; ++l) sum += s[32 * b + (l + b) % 32];
    }
    if (kCount == LANE16) {
        for (int l = 0; l < 32; ++l) {
            sum += (s[32 * (b >> 1) + (l + (b >> 1)) % 32] >> (16 * (b & 1))) & 0xFFFF;
        }
    }
    if (kCount == WARP16) {
        for (int w = 0; w < kThreads / 32; ++w) {
            sum += (s[128 * w + (b >> 1)] >> (16 * (b & 1))) & 0xFFFF;
        }
    }
    return sum;
}

template <int kCount, int kRuns>
__device__ __forceinline__ void count16(int* s, const uint4& v) {
    if (kRuns && v.x == v.y && v.x == v.z && v.x == v.w && v.x == __byte_perm(v.x, 0, 0)) {
        count<kCount>(s, v.x & 0xFF, 16);
        return;
    }
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        if (kRuns == 2 && w[j] == __byte_perm(w[j], 0, 0)) {
            count<kCount>(s, w[j] & 0xFF, 4);
            continue;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) count<kCount>(s, (w[j] >> (8 * i)) & 0xFF, 1);
    }
}

template <int kCount, int kFlush, int kThreads, int kRuns>
__global__ void __launch_bounds__(kThreads)
histogram_variant(const uint8_t* __restrict__ values, int* __restrict__ hist,
                  int* __restrict__ scratch, long long n) {
    __shared__ int s[words<kCount, kThreads>()];
    __shared__ bool last;
    for (int i = threadIdx.x; i < words<kCount, kThreads>(); i += kThreads) s[i] = 0;
    __syncthreads();

    // The bytes before the first 16-byte boundary and after the last, then
    // the 16-byte words between.
    const long long head = min(n, static_cast<long long>(-reinterpret_cast<uintptr_t>(values) & 15));
    const long long n_vec = (n - head) / 16;
    const long long tail = n - head - 16 * n_vec;
    if (blockIdx.x == 0) {
        if (threadIdx.x < head) count<kCount>(s, values[threadIdx.x], 1);
        if (threadIdx.x < tail) count<kCount>(s, values[n - tail + threadIdx.x], 1);
    }
    const uint4* v4 = reinterpret_cast<const uint4*>(values + head);
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n_vec;
         i += 4 * stride) {
        uint4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            if (i + u * stride < n_vec) v[u] = __ldg(v4 + i + u * stride);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            if (i + u * stride < n_vec) count16<kCount, kRuns>(s, v[u]);
        }
    }
    __syncthreads();

    const int b = threadIdx.x;
    const int sum = b < 256 ? total<kCount, kThreads>(s, b) : 0;
    if (kFlush == GLOBAL_ATOMS && b < 256 && sum) atomicAdd(&hist[b], sum);
    if (kFlush == NO_FLUSH && sum < 0) hist[b] = sum;  // never: keeps the counting alive
    if (kFlush == PACKED64 && b < 256) {
        auto* packed = reinterpret_cast<unsigned long long*>(scratch);
        const unsigned long long old =
            atomicAdd(&packed[b], (1ull << 32) | static_cast<unsigned>(sum));
        if ((old >> 32) == gridDim.x - 1) {
            hist[b] = static_cast<int>(old & 0xFFFFFFFFu) + sum;
            packed[b] = 0;
        }
    }
    if (kFlush == ROWS_TICKET || kFlush == ACC_TICKET) {
        int* ticket = scratch + 256;
        int* rows = scratch + 512;
        if (b < 256) {
            if (kFlush == ROWS_TICKET) rows[256 * blockIdx.x + b] = sum;
            else if (sum) atomicAdd(&scratch[b], sum);
        }
        __threadfence();
        __syncthreads();
        if (b == 0) last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
        __syncthreads();
        if (last && b < 256) {
            __threadfence();
            int all = 0;
            if (kFlush == ROWS_TICKET) {
                for (unsigned r = 0; r < gridDim.x; ++r) all += __ldcg(&rows[256 * r + b]);
            } else {
                all = __ldcg(&scratch[b]);
                scratch[b] = 0;
            }
            hist[b] = all;
            if (b == 0) *ticket = 0;
        }
    }
}

// kPerSm: resident blocks per SM (0: as many as the occupancy API allows).
template <int kCount, int kFlush, int kThreads, int kRuns, bool kResident, int kPerSm = 0>
int launch(const void* values, void* hist, void* scratch, long long n, int device,
           cudaStream_t stream, int* blocks_out) {
    const auto kernel = histogram_variant<kCount, kFlush, kThreads, kRuns>;
    long long blocks = (n / 16 + kThreads - 1) / kThreads;
    int cap = 1024;
    if (kResident) {
        int sms = 0, per_sm = 0;
        cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        if (err == cudaSuccess) {
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
        }
        if (err != cudaSuccess) return static_cast<int>(err);
        cap = (kPerSm ? kPerSm : per_sm > 0 ? per_sm : 1) * sms;
    }
    if (blocks < 1) blocks = 1;
    if (blocks > cap) blocks = cap;
    *blocks_out = static_cast<int>(blocks);
    kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const uint8_t*>(values), static_cast<int*>(hist),
        static_cast<int*>(scratch), n);
    return static_cast<int>(cudaGetLastError());
}

// ---- The kept design (csrc/histogram.cu) with its choices as parameters ----
//
// kBatch: 16-byte loads in flight per thread. kFoldAll: kThreads / 256
// threads sum each bin's 32 counters (shuffles join them), else one thread
// per bin. kFlush: PACKED64, GLOBAL_ATOMS or NO_FLUSH (a cut). kCount: false
// is a cut that loads the bytes and counts none of them. kDiv: one block per
// kDiv SMs. kGroups > 1: the PACKED64 flush in two levels, so that fewer
// atomics queue on one address: block i arrives on the words of group
// i % kGroups, and each group's last arrival hands the group's total in on
// the top words, whose last arrival stores the bin.

template <int kThreads, int kBatch, bool kFoldAll, int kFlush, bool kCount, int kGroups>
__global__ void __launch_bounds__(kThreads)
histogram_tuned(const uint8_t* __restrict__ values, int* __restrict__ hist,
                int* __restrict__ scratch, long long n) {
    __shared__ __align__(16) int counts[256 * 32];
    const int head = static_cast<int>(min(n, static_cast<long long>(-reinterpret_cast<uintptr_t>(values) & 15)));
    const int n_vec = static_cast<int>((n - head) / 16);
    const int tail = static_cast<int>(n - head) - 16 * n_vec;
    const uint4* v4 = reinterpret_cast<const uint4*>(values + head);
    const int stride = gridDim.x * kThreads;
    auto load = [&](uint4* v, int i) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            if (i + u * stride < n_vec) v[u] = __ldg(v4 + i + u * stride);
        }
    };
    int i = blockIdx.x * kThreads + threadIdx.x;
    uint4 v[kBatch], next[kBatch];
    load(v, i);
    for (int k = threadIdx.x; k < 256 * 32 / 4; k += kThreads) {
        reinterpret_cast<uint4*>(counts)[k] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
    if (blockIdx.x == 0) {
        if (threadIdx.x < head) count<LANE32>(counts, values[threadIdx.x], 1);
        if (threadIdx.x < tail) count<LANE32>(counts, values[n - tail + threadIdx.x], 1);
    }
    uint32_t unused = 0;
    for (; i < n_vec; i += kBatch * stride) {
        load(next, i + kBatch * stride);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            if (i + u * stride < n_vec) {
                if (kCount) count16<LANE32, 1>(counts, v[u]);
                else unused ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
            }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) v[u] = next[u];
    }
    if (!kCount && unused == 0x12345678u) counts[0] = 1;  // keeps the loads alive
    __syncthreads();

    constexpr int PER_BIN = kFoldAll ? kThreads / 256 : 1;  // threads per bin
    const int b = threadIdx.x / PER_BIN, part = threadIdx.x % PER_BIN;
    if (b >= 256) return;
    int sum = 0;
#pragma unroll
    for (int l = 0; l < 32 / PER_BIN; ++l) {
        sum += counts[32 * b + (32 / PER_BIN * part + l + b) % 32];
    }
#pragma unroll
    for (int d = 1; d < PER_BIN; d *= 2) sum += __shfl_xor_sync(0xFFFFFFFFu, sum, d);
    if (part != 0) return;
    if (kFlush == GLOBAL_ATOMS && sum) atomicAdd(&hist[b], sum);
    if (kFlush == NO_FLUSH && sum < 0) hist[b] = sum;
    if (kFlush == PACKED64) {
        // Arrives with `add` on `word`; true for the last of `of` arrivals,
        // which gets the total in `add` and leaves the word zero.
        auto arrive = [](unsigned long long* word, unsigned of, int& add) {
            const unsigned long long old =
                atomicAdd(word, (1ull << 32) | static_cast<unsigned>(add));
            if ((old >> 32) != of - 1) return false;
            add += static_cast<int>(old & 0xFFFFFFFFu);
            *word = 0;
            return true;
        };
        auto* packed = reinterpret_cast<unsigned long long*>(scratch);
        if (kGroups == 1) {
            if (arrive(&packed[b], gridDim.x, sum)) hist[b] = sum;
        } else {
            const unsigned groups = min(static_cast<unsigned>(kGroups), gridDim.x);
            const unsigned g = blockIdx.x % groups;
            const unsigned size = (gridDim.x - g + groups - 1) / groups;
            if (arrive(&packed[256 * (g + 1) + b], size, sum) &&
                arrive(&packed[b], groups, sum)) {
                hist[b] = sum;
            }
        }
    }
}

template <int kThreads, int kBatch, bool kFoldAll, int kFlush, bool kCount, int kDiv = 1,
          int kGroups = 1>
int launch_tuned(const void* values, void* hist, void* scratch, long long n, int device,
                 cudaStream_t stream, int* blocks_out) {
    int sms = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    long long blocks = (n / 16 + kThreads - 1) / kThreads;
    if (blocks < 1) blocks = 1;
    if (blocks > sms / kDiv) blocks = sms / kDiv;
    *blocks_out = static_cast<int>(blocks);
    histogram_tuned<kThreads, kBatch, kFoldAll, kFlush, kCount, kGroups>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            static_cast<const uint8_t*>(values), static_cast<int*>(hist),
            static_cast<int*>(scratch), n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches variant `variant` (histogram_variants.py names them). `hist` is
// int32[256], zeroed by the caller for the GLOBAL_ATOMS flush; `scratch` is
// int32[512 + 256 * blocks] whose first 512 words are zero between calls.
// `blocks_out` takes the grid size. Returns the launch's cudaGetLastError(),
// or -1 for an unknown variant.
extern "C" int ipt_histogram_variant(int variant, const void* values, void* hist, void* scratch,
                                     long long n, int device, void* stream, int* blocks_out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto s = static_cast<cudaStream_t>(stream);
#define IPT_VARIANT(id, ...) \
    case id: return launch<__VA_ARGS__>(values, hist, scratch, n, device, s, blocks_out)
    switch (variant) {
        IPT_VARIANT(0, BLOCK_ATOMS, GLOBAL_ATOMS, 256, false, false);
        IPT_VARIANT(1, BLOCK_ATOMS, NO_FLUSH, 256, false, false);
        IPT_VARIANT(2, BLOCK_STORES, GLOBAL_ATOMS, 256, false, false);
        IPT_VARIANT(3, BLOCK_ATOMS, GLOBAL_ATOMS, 256, true, false);
        IPT_VARIANT(4, BLOCK_ATOMS, GLOBAL_ATOMS, 1024, true, true);
        IPT_VARIANT(5, BLOCK_ATOMS, GLOBAL_ATOMS, 256, true, true);
        IPT_VARIANT(6, WARP16, GLOBAL_ATOMS, 1024, true, true);
        IPT_VARIANT(7, WARP16, GLOBAL_ATOMS, 256, true, true);
        IPT_VARIANT(8, LANE32, GLOBAL_ATOMS, 1024, true, true);
        IPT_VARIANT(9, LANE32, GLOBAL_ATOMS, 512, true, true);
        IPT_VARIANT(10, LANE32, GLOBAL_ATOMS, 256, true, true);
        IPT_VARIANT(11, LANE16, GLOBAL_ATOMS, 1024, true, true);
        IPT_VARIANT(12, LANE16, GLOBAL_ATOMS, 512, true, true);
        IPT_VARIANT(13, LANE16, GLOBAL_ATOMS, 256, true, true);
        IPT_VARIANT(14, LANE32, ROWS_TICKET, 1024, true, true);
        IPT_VARIANT(15, LANE32, ACC_TICKET, 1024, true, true);
        IPT_VARIANT(16, LANE16, ROWS_TICKET, 1024, true, true);
        IPT_VARIANT(17, LANE16, ACC_TICKET, 1024, true, true);
        IPT_VARIANT(18, LANE16, ACC_TICKET, 512, true, true);
        IPT_VARIANT(19, LANE32, ACC_TICKET, 512, true, true);
        IPT_VARIANT(20, LANE16, ACC_TICKET, 1024, false, true);
        IPT_VARIANT(21, BLOCK_ATOMS, ACC_TICKET, 1024, true, true);
        IPT_VARIANT(22, BLOCK_ATOMS, NO_FLUSH, 1024, true, true);
        IPT_VARIANT(23, LANE32, NO_FLUSH, 1024, true, true);
        IPT_VARIANT(24, BLOCK_ATOMS, PACKED64, 1024, true, true);
        IPT_VARIANT(25, LANE32, PACKED64, 1024, true, true);
        IPT_VARIANT(26, BLOCK_ATOMS, GLOBAL_ATOMS, 1024, true, true, 1);
        IPT_VARIANT(27, BLOCK_ATOMS, PACKED64, 1024, true, true, 1);
        IPT_VARIANT(28, LANE32, GLOBAL_ATOMS, 1024, true, true, 1);
        IPT_VARIANT(29, LANE32, PACKED64, 1024, true, true, 1);
        IPT_VARIANT(30, BLOCK_ATOMS, PACKED64, 512, true, true, 2);
        IPT_VARIANT(31, BLOCK_ATOMS, PACKED64, 512, true, true, 1);
        IPT_VARIANT(32, LANE32, PACKED64, 512, true, true, 1);
        IPT_VARIANT(33, LANE32, PACKED64, 512, true, true, 2);
        IPT_VARIANT(34, LANE32, PACKED64, 768, true, true, 1);
        IPT_VARIANT(35, LANE32, PACKED64, 1024, 2, true, 1);
        IPT_VARIANT(36, BLOCK_ATOMS, PACKED64, 1024, 2, true, 1);
    }
#undef IPT_VARIANT
#define IPT_TUNED(id, ...) \
    case id: return launch_tuned<__VA_ARGS__>(values, hist, scratch, n, device, s, blocks_out)
    switch (variant) {
        IPT_TUNED(100, 1024, 4, false, PACKED64, true);
        IPT_TUNED(101, 1024, 4, false, NO_FLUSH, true);
        IPT_TUNED(102, 1024, 4, false, NO_FLUSH, false);
        IPT_TUNED(103, 1024, 4, false, GLOBAL_ATOMS, true);
        IPT_TUNED(104, 1024, 4, true, PACKED64, true);
        IPT_TUNED(105, 1024, 2, false, PACKED64, true);
        IPT_TUNED(106, 512, 8, false, PACKED64, true);
        IPT_TUNED(107, 512, 4, true, PACKED64, true);
        IPT_TUNED(108, 1024, 8, false, PACKED64, true, 2);
        IPT_TUNED(109, 1024, 8, false, NO_FLUSH, true, 2);
        IPT_TUNED(110, 768, 4, false, PACKED64, true);
        IPT_TUNED(111, 1024, 2, false, PACKED64, true, 1, 4);
        IPT_TUNED(112, 1024, 2, false, PACKED64, true, 1, 12);
        IPT_TUNED(113, 1024, 2, false, PACKED64, true, 1, 33);
        IPT_TUNED(114, 1024, 1, false, PACKED64, true);
        IPT_TUNED(115, 1024, 1, false, PACKED64, true, 1, 12);  // the kept design
        IPT_TUNED(116, 512, 2, false, PACKED64, true, 1, 12);
        IPT_TUNED(117, 512, 4, false, PACKED64, true, 1, 12);
        IPT_TUNED(118, 1024, 2, false, NO_FLUSH, true);
        IPT_TUNED(119, 1024, 2, true, PACKED64, true, 1, 12);
        IPT_TUNED(120, 1024, 1, false, PACKED64, true, 1, 8);
        IPT_TUNED(121, 1024, 1, false, PACKED64, true, 1, 16);
        IPT_TUNED(122, 512, 1, false, PACKED64, true, 1, 12);
        IPT_TUNED(123, 1024, 1, true, PACKED64, true, 1, 12);
        IPT_TUNED(124, 1024, 1, false, NO_FLUSH, true);
        IPT_TUNED(125, 768, 1, false, PACKED64, true, 1, 12);
    }
#undef IPT_TUNED
    return -1;
}
