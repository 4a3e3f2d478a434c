// Every port kernel is launched through ipt::launch: the launch that <<<...>>>
// makes (cudaLaunchKernel with the kernel's arguments), and, where the stream
// is being captured into a CUDA graph, a note of what the graph now holds.
//
// A note is one pointer argument of the launch: the kernel node the capture
// added for it (the capture's one current dependency right after the launch),
// the kernel's argument count, the argument's index and value, and the
// alignment in bytes that the host code chose a kernel for by that address (1
// where it chose nothing by it). utils/graphs.py takes a capture's notes
// (ipt_capture_notes_take) to find the nodes that read a graph's input or
// write its output, and later points those arguments at a caller's buffers
// (ipt_graph_dispatch, csrc/graph_runtime.cu) instead of copying through the
// graph's own.
//
// A launch that is not captured costs one cudaStreamGetCaptureInfo more. A
// captured launch whose node cannot be told is noted with node 0, which
// keeps every buffer it touches bound to the graph's own.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <mutex>
#include <tuple>
#include <type_traits>
#include <utility>
#include <vector>

namespace ipt {

struct Note {
    unsigned long long capture;  // the capture's id (cudaStreamGetCaptureInfo)
    unsigned long long node;     // cudaGraphNode_t of the launch, 0 if unknown
    int nargs;                   // the kernel's arguments
    int index;                   // this argument's
    unsigned long long ptr;      // its value
    int align;                   // the alignment the host code chose a kernel by, else 1
};

struct Notes {
    std::mutex mu;
    std::vector<Note> all;
};

// One registry for the whole library (an inline function's static).
inline Notes& notes() {
    static Notes n;
    return n;
}

// Note the pointer arguments of the launch just made on `stream` if it is
// being captured.
inline cudaError_t note_launch(cudaStream_t stream, int nargs, const int* index,
                               const void* const* ptrs, const int* align, int count) {
    cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
    unsigned long long id = 0;
    cudaGraph_t graph = nullptr;
    const cudaGraphNode_t* deps = nullptr;
    size_t ndeps = 0;
#if CUDART_VERSION >= 13000
    cudaError_t err =
        cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps, nullptr, &ndeps);
#else
    cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps, &ndeps);
#endif
    if (err != cudaSuccess || status != cudaStreamCaptureStatusActive) return err;
    unsigned long long node = 0;
    cudaGraphNodeType type;
    if (ndeps == 1 && cudaGraphNodeGetType(deps[0], &type) == cudaSuccess &&
        type == cudaGraphNodeTypeKernel) {
        node = reinterpret_cast<unsigned long long>(deps[0]);
    }
    cudaGetLastError();  // a failed type query leaves the launch's own status
    std::lock_guard<std::mutex> lock(notes().mu);
    for (int k = 0; k < count; ++k) {
        notes().all.push_back(Note{id, node, nargs, index[k],
                                   reinterpret_cast<unsigned long long>(ptrs[k]), align[k]});
    }
    return cudaSuccess;
}

template <typename T>
void collect(const T& value, int i, int* index, const void** ptrs, int* align, int& count,
             const int*& next, const int* end) {
    if constexpr (std::is_pointer_v<T>) {
        index[count] = i;
        ptrs[count] = value;
        align[count] = next != end ? *next++ : 1;
        ++count;
    }
}

template <typename... Params, size_t... I>
cudaError_t launch_tuple(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                         cudaStream_t stream, std::initializer_list<int> aligns,
                         std::tuple<Params...>& values, std::index_sequence<I...>) {
    void* args[] = {static_cast<void*>(&std::get<I>(values))...};
    cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid, block, args, smem, stream);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    int index[sizeof...(I)];
    const void* ptrs[sizeof...(I)];
    int align[sizeof...(I)];
    int count = 0;
    const int* next = aligns.begin();
    (collect(std::get<I>(values), static_cast<int>(I), index, ptrs, align, count, next,
             aligns.end()),
     ...);
    return note_launch(stream, static_cast<int>(sizeof...(I)), index, ptrs, align, count);
}

// kernel<<<grid, block, smem, stream>>>(args...), its status, and its notes
// under capture. `aligns`: the alignment that the host code chose the kernel
// by for each pointer argument in order (missing ones are 1).
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                   cudaStream_t stream, std::initializer_list<int> aligns, Args... args) {
    static_assert(sizeof...(Params) == sizeof...(Args), "one argument per kernel parameter");
    std::tuple<Params...> values(static_cast<Params>(args)...);
    return launch_tuple(kernel, grid, block, smem, stream, aligns, values,
                        std::index_sequence_for<Params...>{});
}

}  // namespace ipt
