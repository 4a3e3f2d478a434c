"""CUDA graphs: the port's counterpart of the JAX package's ``jax.jit``.

A call of a ``jax.jit`` program with fixed shapes is one dispatch of one
compiled executable (``imageprocessingtools_tpu/kernels/fused.py:75-77``,
``utils/timing.py``'s jitted ``fori_loop``). PyTorch runs eagerly, one
launch per op; the counterpart of such a program is a captured CUDA graph,
which one replay runs on the card with no host work between its launches.

- ``capture(fn, *args)`` warms ``fn(*args)`` up on a side stream (the
  kernels' build, K1's plans, K9's tables, K4's arrival words of that
  stream: whatever a first call makes and caches), then captures
  ``fn(*args)`` on that stream into a ``Captured``, bound to ``args`` by
  pointer. A function that cannot be captured (an upload from the host, a
  synchronisation, an allocation in the C) raises ``CaptureError``, which
  names it and the CUDA error; nothing falls back to eager launches.
- ``graphed(fn)``: ``fn`` (one tensor -> a tensor or a tuple of tensors) as
  a compiled callable. On a CPU tensor it calls ``fn``. On a CUDA tensor it
  keeps one graph per ``graph_key`` (device, shape, dtype, strides) in an
  LRU of ``GRAPH_CACHE_SIZE`` graphs (each holds a memory pool of its own),
  copies the argument into the graph's input buffer, replays it and returns
  a clone of its output: a JAX executable returns a fresh array, and a
  caller that keeps one output must not see the next call overwrite it.

Launch counts (each wrapper's ``.launches``): the warm-up's launches count,
as they run. A capture launches nothing, so the counts it added are taken
back and credited once per replay instead.
"""

from __future__ import annotations

import collections
import dataclasses
import warnings

import torch

GRAPH_CACHE_SIZE = 4  # graphs a ``graphed`` callable keeps, least recently used evicted


class CaptureError(RuntimeError):
    """A function could not be captured into a CUDA graph."""


def _name(fn) -> str:
    return getattr(fn, "__qualname__", None) or getattr(fn, "__name__", None) or repr(fn)


def _counted() -> tuple:
    """Every kernel wrapper that counts its launches."""
    from imageprocessingtools_tpu_torch import kernels

    return kernels.counted_wrappers()


@dataclasses.dataclass
class Captured:
    """One captured graph: ``out`` is its static output (a tensor or a tuple
    of tensors, rewritten by every replay), ``launches`` the launches of
    each counted wrapper that one replay makes."""

    graph: torch.cuda.CUDAGraph
    out: object
    launches: dict

    def replay(self) -> None:
        """Run the graph once on the current stream."""
        self.graph.replay()
        for wrapper, n in self.launches.items():
            wrapper.launches += n


def capture(fn, *args) -> Captured:
    """Capture ``fn(*args)`` (CUDA tensors, read where they lie) into a
    CUDA graph, after one warm-up call on the capture's side stream."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor) and a.is_cuda)
    with torch.cuda.device(device):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn(*args)  # the warm-up: builds, fills the caches, runs
        torch.cuda.synchronize()
        wrappers = _counted()
        before = [w.launches for w in wrappers]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                out = fn(*args)
            except BaseException as e:
                _abandon(graph)
                raise CaptureError(f"{_name(fn)} cannot be captured in a CUDA graph: {e}") from e
            try:
                graph.capture_end()
            except RuntimeError as e:
                raise CaptureError(f"{_name(fn)} cannot be captured in a CUDA graph: {e}") from e
        torch.cuda.current_stream().wait_stream(stream)
        launches = {}
        for w, n in zip(wrappers, before):
            if w.launches != n:
                launches[w] = w.launches - n
                w.launches = n  # a capture launches nothing
    return Captured(graph, out, launches)


def _abandon(graph: torch.cuda.CUDAGraph) -> None:
    """End a capture that ``fn`` left by raising. The capture is invalid then
    (ending it reports that), or empty where torch refused the operation
    before it reached CUDA (ending it warns of that); the caller's error
    explains either, and the graph is dropped."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            graph.capture_end()
        except RuntimeError:
            pass


def graph_key(x: torch.Tensor) -> tuple:
    """What a graph is captured for: the input's device, shape, dtype and
    strides (a pure function of the tensor's metadata)."""
    return (x.device, tuple(x.shape), x.dtype, tuple(x.stride()))


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(_clone(o) for o in out)


@dataclasses.dataclass
class _Entry:
    """A graph of ``Graphed``, its input buffer, and an event recorded after
    its last call's clone (calls on other streams wait for it)."""

    static_in: torch.Tensor
    captured: Captured
    done: torch.cuda.Event = dataclasses.field(default_factory=torch.cuda.Event)


class Graphed:
    """``fn`` as a compiled callable (see the module's docstring)."""

    def __init__(self, fn):
        self.fn = fn
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self.__name__ = _name(fn)
        self.__doc__ = fn.__doc__

    def _lookup(self, key, make):
        """The entry for ``key``, made by ``make()`` on a miss; past
        ``GRAPH_CACHE_SIZE`` entries the least recently used is dropped once
        its last call has finished."""
        entry = self._graphs.pop(key, None)
        if entry is None:
            entry = make()
            while len(self._graphs) >= GRAPH_CACHE_SIZE:
                _, old = self._graphs.popitem(last=False)
                old.done.synchronize()  # its memory goes back to the allocator
        self._graphs[key] = entry
        return entry

    def _make(self, x: torch.Tensor) -> _Entry:
        static_in = torch.empty_like(x)
        static_in.copy_(x)
        return _Entry(static_in, capture(self.fn, static_in))

    def __call__(self, x: torch.Tensor):
        if x.device.type != "cuda":
            return self.fn(x)
        with torch.cuda.device(x.device):
            entry = self._lookup(graph_key(x), lambda: self._make(x))
            torch.cuda.current_stream().wait_event(entry.done)
            entry.static_in.copy_(x)
            entry.captured.replay()
            out = _clone(entry.captured.out)
            entry.done.record()
        return out


def graphed(fn) -> Graphed:
    """``fn`` (a tensor -> a tensor or a tuple of tensors) replayed from a
    CUDA graph on a CUDA tensor, called as it is on a CPU tensor."""
    return Graphed(fn)
