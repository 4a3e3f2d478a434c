// The kernel library's runtime, shared by every kernel's file: the error
// text of a status, a CUDA graph's capture notes (csrc/launch.cuh), and the
// kept dispatch that binds a caller's buffers into an instantiated graph's
// kernel nodes and launches it (utils/graphs.py::_Dispatch). It launches no
// kernel of its own.

#include <cuda_runtime.h>

#include <memory>
#include <mutex>
#include <vector>

#include "launch.cuh"

// Shared by every entry point's wrapper to word its errors.
extern "C" const char* ipt_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}

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
