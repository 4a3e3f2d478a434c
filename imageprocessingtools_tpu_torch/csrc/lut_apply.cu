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

#include <memory>
#include <vector>

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

// Shared by every entry point's wrapper to word its errors.
extern "C" const char* ipt_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// A CUDA graph's notes and bindings (csrc/launch.cuh, utils/graphs.py), shared
// by every kernel's file.

// The id of the capture underway on `stream` into *id, or 0 if none.
extern "C" int ipt_capture_id(void* stream, unsigned long long* id) {
    cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
    *id = 0;
    const auto s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = cudaStreamGetCaptureInfo(s, &status, id);
    if (status != cudaStreamCaptureStatusActive) *id = 0;
    return static_cast<int>(err);
}

// The number of notes of capture `id` into *count.
extern "C" int ipt_capture_note_count(unsigned long long id, int* count) {
    std::lock_guard<std::mutex> lock(ipt::notes().mu);
    *count = 0;
    for (const ipt::Note& n : ipt::notes().all) *count += n.capture == id;
    return 0;
}

// Up to `max` notes of capture `id` into out, in launch order; drops every
// note of that capture and of the captures before it (an abandoned
// capture's too).
extern "C" int ipt_capture_notes_take(unsigned long long id, ipt::Note* out, int max) {
    std::lock_guard<std::mutex> lock(ipt::notes().mu);
    std::vector<ipt::Note>& all = ipt::notes().all;
    int k = 0;
    std::vector<ipt::Note> later;
    for (const ipt::Note& n : all) {
        if (n.capture == id && k < max) out[k++] = n;
        if (n.capture > id) later.push_back(n);
    }
    all.swap(later);
    return 0;
}

// A kept dispatch of one instantiated graph (utils/graphs.py::_Dispatch):
// the kernel nodes whose arguments hold the graph's input or output, each
// node's parameters as captured (taken once, from the graph's own node,
// which the caller keeps alive with the dispatch), and the addresses that
// the instantiated graph holds in those arguments now.
struct Dispatch {
    struct Node {
        cudaGraphNode_t node;
        cudaKernelNodeParams params;  // kernelParams: the arguments as the node holds them
        std::vector<void*> args;      // what is set: the node's, a bound one's &now[k]
        std::vector<int> bindings;    // indices into role, offset and now
    };
    cudaGraphExec_t exec;
    std::vector<Node> nodes;
    std::vector<int> role;                   // a binding's buffer: 0 the input, 1 the output
    std::vector<unsigned long long> offset;  // its byte offset into that buffer
    std::vector<unsigned long long> now;     // the address the graph holds there now
};

// A dispatch of the instantiated graph `exec` into *out: `count` bindings,
// binding i argument index[i] (of nargs[i]) of kernel node nodes[i], holding
// the input (roles[i] 0) or the output (1) at byte offsets[i]; the graph
// holds own_in and own_out now. A node's bindings are consecutive. Free it
// with ipt_dispatch_free.
extern "C" int ipt_dispatch_new(void* exec, int count, const unsigned long long* nodes,
                                const int* nargs, const int* index, const int* roles,
                                const unsigned long long* offsets, unsigned long long own_in,
                                unsigned long long own_out, void** out) {
    *out = nullptr;
    auto d = std::make_unique<Dispatch>();
    d->exec = static_cast<cudaGraphExec_t>(exec);
    d->role.assign(roles, roles + count);
    d->offset.assign(offsets, offsets + count);
    d->now.resize(count);  // never resized again: the nodes' args point into it
    for (int i = 0; i < count; ++i) d->now[i] = (roles[i] ? own_out : own_in) + offsets[i];
    for (int i = 0; i < count;) {
        Dispatch::Node n;
        n.node = reinterpret_cast<cudaGraphNode_t>(nodes[i]);
        cudaError_t err = cudaGraphKernelNodeGetParams(n.node, &n.params);
        if (err != cudaSuccess) return static_cast<int>(err);
        n.args.assign(n.params.kernelParams, n.params.kernelParams + nargs[i]);
        int j = i;
        for (; j < count && nodes[j] == nodes[i]; ++j) {
            if (nargs[j] != nargs[i] || index[j] < 0 || index[j] >= nargs[i]) {
                return static_cast<int>(cudaErrorInvalidValue);
            }
            n.args[index[j]] = &d->now[j];
            n.bindings.push_back(j);
        }
        n.params.kernelParams = nullptr;  // set per call from args
        n.params.extra = nullptr;
        d->nodes.push_back(std::move(n));
        i = j;
    }
    *out = d.release();
    return 0;
}

extern "C" int ipt_dispatch_free(void* dispatch) {
    delete static_cast<Dispatch*>(dispatch);
    return 0;
}

// One call of a kept dispatch on `stream`, its steps chosen by `flags`:
// IPT_WAIT, wait for the event `done` (the graph's last call); then point
// the bound arguments at the input `src` and the output `dst` where they
// differ from what the graph holds (launches already enqueued keep theirs);
// IPT_LAUNCH, launch the graph; IPT_RECORD, record `done`.
constexpr int IPT_WAIT = 1, IPT_LAUNCH = 2, IPT_RECORD = 4;

extern "C" int ipt_graph_dispatch(void* dispatch, void* stream, unsigned long long src,
                                  unsigned long long dst, void* done, int flags) {
    auto* d = static_cast<Dispatch*>(dispatch);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto event = static_cast<cudaEvent_t>(done);
    cudaError_t err = cudaSuccess;
    if (flags & IPT_WAIT) {
        err = cudaStreamWaitEvent(s, event, 0);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    for (Dispatch::Node& n : d->nodes) {
        bool moved = false;
        for (int k : n.bindings) moved |= d->now[k] != (d->role[k] ? dst : src) + d->offset[k];
        if (!moved) continue;
        for (int k : n.bindings) d->now[k] = (d->role[k] ? dst : src) + d->offset[k];
        cudaKernelNodeParams p = n.params;
        p.kernelParams = n.args.data();
        err = cudaGraphExecKernelNodeSetParams(d->exec, n.node, &p);
        if (err != cudaSuccess) {
            for (int k : n.bindings) d->now[k] = ~0ULL;  // unknown: the next call sets it again
            return static_cast<int>(err);
        }
    }
    if (flags & IPT_LAUNCH) {
        err = cudaGraphLaunch(d->exec, s);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (flags & IPT_RECORD) err = cudaEventRecord(event, s);
    return static_cast<int>(err);
}
