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
  names it and the CUDA error; nothing falls back to eager launches. An
  allocation failure inside the capture (``MemoryError``, which
  ``kernels.TooLarge`` is, or ``torch.OutOfMemoryError``) is raised as it
  is (``capture_failure``), so that the CLI and ``serve`` answer it with the
  C's allocation message. A ``graphed`` callable called inside a capture
  (its warm-up too) runs its body, which the outer graph captures, as a
  jitted function inlines under ``jax.jit``.
- ``device_table(maxsize)``: an ``lru_cache`` for tables on the device that
  a captured launch reads by pointer (K1's plan, K9's tables, K8's chain
  table, the contrast LUT): a capture underway keeps every table it was
  given, so that the table lives as long as the graph whatever the cache
  evicts.
- ``graphed(fn)``: ``fn`` (one tensor -> a tensor or a tuple of tensors) as
  a compiled callable. On a CPU tensor it calls ``fn``. On a CUDA tensor it
  keeps one graph per ``graph_key`` (device, shape, dtype, strides), takes
  the argument as inputs are taken (below), replays the graph and returns a
  fresh output: one tensor the graph wrote where it lies where the output
  can be bound, else a clone of the graph's own. A JAX executable returns
  a fresh array, and a caller that keeps one output must not see the next
  call overwrite it.
- ``batched(fn)``: ``fn`` over a leading dimension, the counterpart of
  ``jax.jit(jax.vmap(fn))`` (``imageprocessingtools_tpu/serving.py:147-149``,
  ``parallel/batch.py:53-92``). N images of one shape run in groups of G
  (``group_size``: as many as ``GROUP_INPUT_BYTES`` of input hold, at most
  ``GROUP_IMAGES``; ``spans``): on a CUDA device, one graph per (fn,
  device, image shape, dtype, images in the group), and one plan per
  ``plan_key`` (the device, and the batch's device, shape, dtype and
  strides) that every call with the key runs while it holds (``_Plan``),
  made by finding or capturing the groups' graphs: fresh outputs, then one
  replay of each group's graph (⌊N/G⌋ of the G-image graph, one of the
  remainder's), each group and its rows of the output bound where the plan
  places them and their addresses are aligned (below), else copied in and
  out.
  A group is ``over_group(fn, group)``: where ``fn``
  has a batch form (below), that form on the whole group, whose kernels
  launch once per group (``jax.vmap``'s batching rule: one kernel over the
  batch) and whose outputs are stacked already (one copy out per output);
  else ``fn`` on each image in turn, one launch per image and kernel, stacked
  out. Every serving task and fan-out element has a batch form; only a
  function without one (the staged flagship, an arbitrary ``batch_apply``
  function) runs per image. On a CPU device the same group body runs eagerly
  (a batch form through the kernels' plain batch versions);
  ``eager_batch`` is the per-image loop, the plain form of this dispatch.
- ``batch_form(single)``: declares the decorated function the batch form of
  ``single``: uint8[N, ...] -> outputs with a leading N, image i's as
  ``single(images[i])`` gives it (a tuple output may hold, for an element
  that has no batch form, a list of per-image outputs). A function that has
  a batch form never runs per image in ``batched``: if its capture fails,
  it raises as any capture does.
- ``replayed(cache, key, fn, x, name)``: the band pipelines' path
  (``parallel/spatial.py``): the graph kept for ``key``, captured on a
  miss, ``x`` taken in, one replay, its static output inside the block.
  Every replay (``graphed``'s, a plan's, ``replayed``'s) is one ``_replay``.

How inputs are taken. Every port kernel is launched through
``csrc/launch.cuh``, which under capture notes each pointer argument with
its kernel node and the alignment its host code chose the kernel by; a
capture keeps its ``cudaGraph_t`` (so that the nodes stay valid), those
notes, and the storages that torch ops took while it ran. From these,
``input_site`` and ``output_site`` say where a caller's buffer may take the
place of the graph's own: the input where only noted port kernels read it
(no torch op, no memcpy node, no output inside it); the output where it is
one tensor, its storage whole, that one noted argument holds from its first
byte and no torch op takes (K3's batch, K9's H pass, K8 after K1, K10's
packed bits; not a tuple, a per-image list or bits packed by torch ops, as
the reference ``-mono`` path's are). Notes taken before
the capture made the output's storage do not count: the graph's pool may
give the output an earlier stage's freed buffer, which those launches wrote,
and nothing reads it after them. ``bindable`` decides: a buffer
``placeable`` at the site (on the graph's card, of its shape, contiguous; a
plan decides it once) and ``aligned`` (at an address that meets every noted
alignment; every call) is bound: an input, and the output of a call whose
input is on the card. A replay is ``_Dispatch``'s native call,
``ipt_graph_dispatch``: it waits for the graph's last call where another
stream made it, sets a noted node's arguments
(``cudaGraphExecKernelNodeSetParams``, from the parameters taken once from
the node) where the addresses differ from what the graph holds (launches
already enqueued keep theirs), launches the instantiated graph and records
the graph's event. A graph that draws random numbers cannot be captured:
such a launch would draw the same ones again. Anything else, and every host
input, is copied into the graph's input (a fallback points the kernels back
at the graph's own buffers first), and its outputs copied out. There is no
switch: what the code observes decides.

Memory: each graph holds a pool of its own. Every graph that ``graphed``,
``batched`` and the band pipelines keep is in one LRU (``held``) with its
bytes (its static input and what the allocator reserved during its capture).
After each capture the least recently used graphs are dropped until those
kept hold at most ``GRAPH_BYTES_BOUND`` bytes (a single graph above the
bound stays alone), and the allocator's cache is emptied so that their pools
go back to the card. The LRU is for one thread: serving replays from its
main thread only.

Launch counts (each wrapper's ``.launches``): the warm-up's launches count,
as they run. A capture launches nothing, so the counts it added are taken
back and credited once per replay instead.

Counters (``counts()``; always on): graphs captured, graphs the byte bound
dropped, replays, bytes copied from the host into a graph's input
(``upload_bytes``), replays whose input and whose output were bound
(``inputs_bound``, ``outputs_bound``), and bytes copied card to card into a
graph's input (``copy_in_bytes``, the fallback) and out of a graph's
outputs that were not bound (``copy_out_bytes``); apart from these,
``dispatch_plans_made`` and ``dispatch_plan_hits`` (the plans of batches on
a card, and the calls that took one). Spans (``utils.profiling.span``,
recorded only inside a recording; they change no native call):
``graphs.capture``, ``graphs.evict`` (the bound's drops, each waiting for
its graph's last call, and the emptied cache), ``graphs.upload`` (the copy
of a host input into the graph's) or ``graphs.copy_in`` (of an unbound
input on a card), ``graphs.replay`` (the launch, and a bound replay's
bind); in ``batched``, ``graphs.group`` around each group and
``graphs.copy_out`` around the copy of outputs that were not bound out of
the graph.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import time
import warnings
import weakref
from typing import NamedTuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from imageprocessingtools_tpu_torch.utils import profiling

GRAPH_BYTES_BOUND = 8 << 30  # bytes of all graphs kept together (a single larger one stays)
GROUP_INPUT_BYTES = 256 << 20  # a ``batched`` group's input bytes at most (unless it is one image)
GROUP_IMAGES = 65535  # a ``batched`` group's images at most: a batched kernel's grid axis


class CaptureError(RuntimeError):
    """A function could not be captured into a CUDA graph."""


def _name(fn) -> str:
    return getattr(fn, "__qualname__", None) or getattr(fn, "__name__", None) or repr(fn)


def _counted() -> tuple:
    """Every kernel wrapper that counts its launches."""
    from imageprocessingtools_tpu_torch import kernels

    return kernels.counted_wrappers()


def _library():
    """The port's kernel library (``kernels/_build.py``)."""
    from imageprocessingtools_tpu_torch.kernels import _build

    return _build


class Note(NamedTuple):
    """One pointer argument of a port kernel launched under capture
    (``csrc/launch.cuh``): its kernel node (0 where the capture could not
    tell it), the kernel's argument count, the argument's index and value,
    and the alignment in bytes that the host code chose the kernel by (1
    where the address chose nothing)."""

    node: int
    nargs: int
    index: int
    ptr: int
    align: int


class _CNote(ctypes.Structure):
    _fields_ = [("capture", ctypes.c_ulonglong), ("node", ctypes.c_ulonglong),
                ("nargs", ctypes.c_int), ("index", ctypes.c_int), ("ptr", ctypes.c_ulonglong),
                ("align", ctypes.c_int)]


class _Touches(TorchDispatchMode):
    """While a function is captured: the card storages that torch ops other
    than views take, to read or to write, and for each storage an op made
    (one that is none of its arguments': an allocation) how many port kernel
    notes the capture held then (``noted()``). With the port kernels' notes,
    they say what touches a graph's input and output. ``seeded``: the first
    op that drew random numbers (a replay launched by ``ipt_graph_dispatch``
    would draw the same ones again)."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # Else torch wraps __torch_dispatch__ to disable torch.compile in it,
        # and the first capture imports torch._dynamo (9 s on the card's host).
        return False

    def __init__(self, noted=lambda: 0):
        super().__init__()
        self._seen = {}  # a storage's weak reference -> its (address, bytes)
        self._made = {}  # a storage's weak reference -> (its address, notes before it)
        self._noted = noted
        self.seeded = None  # the first op that drew random numbers, if any

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        result = func(*args, **kwargs)
        if self.seeded is None and torch.Tag.nondeterministic_seeded in func.tags:
            self.seeded = func
        if not getattr(func, "is_view", False):
            taken = set()
            for t in pytree.tree_leaves((args, kwargs)):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    ref = StorageWeakRef(t.untyped_storage())
                    taken.add(ref)
                    self._seen.setdefault(ref, _storage(t))
            for t in pytree.tree_leaves(result):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    ref = StorageWeakRef(t.untyped_storage())
                    if ref not in taken and ref not in self._made:
                        self._made[ref] = (_storage(t)[0], self._noted())
        return result

    def ranges(self) -> tuple:
        """(address, bytes) of each storage taken that is still alive: the
        bytes of one freed since may hold a later buffer that no op took."""
        return tuple(r for ref, r in self._seen.items() if not ref.expired())

    def made(self) -> dict:
        """address -> the notes taken before the storage there was made, for
        each storage made that is still alive."""
        return dict(r for ref, r in self._made.items() if not ref.expired())


def _storage(t: torch.Tensor) -> tuple:
    """(address, bytes) of ``t``'s whole storage."""
    s = t.untyped_storage()
    return s.data_ptr(), s.nbytes()


@dataclasses.dataclass
class Captured:
    """One captured graph: ``out`` is its static output (what ``fn``
    returned, rewritten by every replay), ``launches`` the launches of
    each counted wrapper that one replay makes, ``pool_bytes`` what the
    allocator reserved for it during the capture, ``holds`` the tables made
    outside the capture that it reads, ``notes`` the pointer arguments of
    the port kernels it launches, ``touched`` the storages that torch ops
    in it take and ``made`` the notes taken before each storage it made
    (``_Touches``)."""

    graph: torch.cuda.CUDAGraph
    out: object
    launches: dict
    pool_bytes: int = 0
    holds: list = dataclasses.field(default_factory=list)
    notes: tuple = ()
    touched: tuple = ()
    made: dict = dataclasses.field(default_factory=dict)

    def replay(self) -> None:
        """Run the graph once on the current stream."""
        self.graph.replay()
        for wrapper, n in self.launches.items():
            wrapper.launches += n


_holds: list | None = None  # while a capture (its warm-up too) is underway: the tables it reads


def capturing() -> bool:
    """Whether a capture is underway on this thread's current stream, or
    ``capture``'s warm-up for one."""
    return _holds is not None or (torch.cuda.is_available()
                                  and torch.cuda.is_current_stream_capturing())


def device_table(maxsize: int):
    """``functools.lru_cache(maxsize)`` for a function that makes a table on
    a device which captured launches read by pointer: while a capture is
    underway, the graph keeps every table it was given, so that eviction
    from the cache cannot free a table that a graph still reads."""

    def decorate(make):
        cached = functools.lru_cache(maxsize=maxsize)(make)

        @functools.wraps(make)
        def table(*args):
            out = cached(*args)
            if _holds is not None:
                _holds.append(out)
            return out

        table.cache_clear, table.cache_info = cached.cache_clear, cached.cache_info
        return table

    return decorate


def capture_failure(fn, error: BaseException) -> BaseException:
    """What a capture of ``fn`` raises when ``error`` ended it: an
    allocation failure (``MemoryError``, which ``kernels.TooLarge`` is, and
    ``torch.OutOfMemoryError``) and anything that is not an ``Exception``
    as they are; anything else as a ``CaptureError`` naming ``fn``."""
    if not isinstance(error, Exception) or isinstance(error, (MemoryError,
                                                              torch.OutOfMemoryError)):
        return error
    return CaptureError(f"{_name(fn)} cannot be captured in a CUDA graph: {error}")


def _fail(fn, error: BaseException):
    failure = capture_failure(fn, error)
    if failure is error:
        raise error
    raise failure from error


def capture(fn, *args) -> Captured:
    """Capture ``fn(*args)`` (CUDA tensors, read where they lie) into a
    CUDA graph, after one warm-up call on the capture's side stream."""
    global _holds
    device = next(a.device for a in args if isinstance(a, torch.Tensor) and a.is_cuda)
    outer, _holds = _holds, []
    holds = _holds
    try:
        with torch.cuda.device(device):
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                fn(*args)  # the warm-up: builds, fills the caches, runs
            torch.cuda.synchronize()
            wrappers = _counted()
            before = [w.launches for w in wrappers]
            lib = _library().library()
            graph = torch.cuda.CUDAGraph(keep_graph=True)  # its nodes stay, for bindings
            reserved = torch.cuda.memory_reserved(device)
            capture_id = ctypes.c_ulonglong()
            try:
                with torch.cuda.stream(stream):
                    graph.capture_begin()
                    try:
                        lib.ipt_capture_id(stream.cuda_stream, ctypes.byref(capture_id))
                        with _Touches(functools.partial(_note_count, lib, capture_id.value)) \
                                as touches:
                            out = fn(*args)
                        if touches.seeded is not None:
                            raise RuntimeError(f"{touches.seeded} draws random numbers, which "
                                               "every replay would draw again")
                        touched, made = touches.ranges(), touches.made()
                    except BaseException:
                        _abandon(graph)
                        raise
                    graph.capture_end()
                graph.instantiate()
            except BaseException as e:
                for w, n in zip(wrappers, before):
                    w.launches = n  # nothing of the capture ran
                _fail(fn, e)
            notes = _take_notes(lib, capture_id.value)
            torch.cuda.current_stream().wait_stream(stream)
            launches = {}
            for w, n in zip(wrappers, before):
                if w.launches != n:
                    launches[w] = w.launches - n
                    w.launches = n  # a capture launches nothing
            pool_bytes = torch.cuda.memory_reserved(device) - reserved
    finally:
        _holds = outer
    return Captured(graph, out, launches, pool_bytes, holds, notes, touched, made)


def _note_count(lib, capture_id: int) -> int:
    """How many notes capture ``capture_id`` holds so far."""
    count = ctypes.c_int()
    lib.ipt_capture_note_count(capture_id, ctypes.byref(count))
    return count.value


def _take_notes(lib, capture_id: int) -> tuple:
    """The notes of capture ``capture_id``, taken out of the library's."""
    count = _note_count(lib, capture_id)
    buf = (_CNote * count)()
    lib.ipt_capture_notes_take(capture_id, buf, count)
    return tuple(Note(n.node, n.nargs, n.index, n.ptr, n.align) for n in buf)


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


def _copied_out(out) -> None:
    """Count the bytes of a graph's outputs ``out`` (a tensor, or a tuple
    or list of them) that are copied out of it."""
    global copy_out_bytes
    copy_out_bytes += sum(t.nbytes for t in pytree.tree_leaves(out)
                          if isinstance(t, torch.Tensor))


class Buffer(NamedTuple):
    """Where a tensor lies: its device, shape, strides, address and bytes."""

    device: torch.device
    shape: tuple
    strides: tuple
    ptr: int
    nbytes: int

    @classmethod
    def of(cls, t: torch.Tensor) -> Buffer:
        return cls(t.device, tuple(t.shape), tuple(t.stride()), t.data_ptr(), t.nbytes)


class Binding(NamedTuple):
    """A kernel argument that holds a graph's input or output: its node, the
    kernel's argument count, the argument's index, its byte offset into the
    buffer, and the alignment that its launch was chosen by."""

    node: int
    nargs: int
    index: int
    offset: int
    align: int


class Site(NamedTuple):
    """A graph's input or output where a caller's buffer may take the place
    of the graph's own: the buffer's device, shape and strides, and the
    kernel arguments that hold it."""

    device: torch.device
    shape: tuple
    strides: tuple
    bindings: tuple


def _dense(shape: tuple, strides: tuple) -> bool:
    """Whether ``strides`` are the contiguous ones of ``shape`` (a pure
    function; a dimension of one element may have any stride)."""
    step = 1
    for n, stride in zip(reversed(shape), reversed(strides)):
        if n != 1 and stride != step:
            return False
        step *= n
    return True


def _overlaps(ranges, ptr: int, nbytes: int) -> bool:
    """Whether any (address, bytes) of ``ranges`` shares a byte with
    [ptr, ptr + nbytes)."""
    return any(lo < ptr + nbytes and ptr < lo + size for lo, size in ranges)


def _held_by(notes, buf: Buffer) -> list:
    return [n for n in notes if buf.ptr <= n.ptr < buf.ptr + buf.nbytes]


def input_site(static: Buffer, notes, touched, outs) -> Site | None:
    """A graph's input ``static`` as a ``Site``, or None where a caller's
    buffer cannot take its place: where no port kernel reads it, a torch op
    takes it (``touched``: (address, bytes) of the storages that torch ops
    took during the capture; a memcpy node comes from one too), a launch
    whose node is unknown reads it, or an output lies in it (``outs``:
    (address, bytes) of each output's storage). ``notes``: the capture's.
    A port kernel never writes its input, so a bound input is only read (a
    pure function)."""
    refs = _held_by(notes, static)
    if (not refs or not _dense(static.shape, static.strides) or any(n.node == 0 for n in refs)
            or _overlaps((*touched, *outs), static.ptr, static.nbytes)):
        return None
    return Site(static.device, static.shape, static.strides,
                tuple(Binding(n.node, n.nargs, n.index, n.ptr - static.ptr, n.align)
                      for n in refs))


def output_site(out: Buffer | None, notes, touched, static_in: Buffer,
                first: int = 0) -> Site | None:
    """A graph's output ``out`` as a ``Site``, or None where a caller's buffer
    cannot take its place: ``out`` is None (a tuple, a list, or a view of
    part of a storage), or it is not the one recorded kernel argument's
    buffer from its first byte on, a torch op takes it, or it lies in the
    input (a pure function). The ``first`` notes were taken before the
    capture made ``out``'s storage: they point into bytes freed before it
    (an earlier stage's buffer, which the graph's pool gave to the output)
    and hold nothing of it."""
    if out is None or not _dense(out.shape, out.strides):
        return None
    refs = _held_by(notes[first:], out)
    if (len(refs) != 1 or refs[0].ptr != out.ptr or refs[0].node == 0
            or _overlaps((*touched, (static_in.ptr, static_in.nbytes)), out.ptr, out.nbytes)):
        return None
    n = refs[0]
    return Site(out.device, out.shape, out.strides,
                (Binding(n.node, n.nargs, n.index, 0, n.align),))


def placeable(x: Buffer, site: Site | None) -> bool:
    """Whether ``x`` may take the place of a graph's buffer at ``site`` (None:
    nowhere) wherever it lies: on the graph's card, of its shape, and
    contiguous (a pure function of the buffer's device, shape and strides)."""
    return (site is not None and x.device == site.device and x.shape == site.shape
            and _dense(x.shape, x.strides))


def aligned(ptr: int, site: Site | None) -> bool:
    """Whether a buffer at ``ptr`` meets every alignment that a launch
    holding ``site`` was chosen by (a pure function; None: nothing to meet)."""
    return site is None or all((ptr + b.offset) % b.align == 0 for b in site.bindings)


def bindable(x: Buffer, site: Site | None) -> bool:
    """Whether ``x`` may take the place of a graph's buffer at ``site`` (None:
    nowhere) for one replay: ``placeable``, and at an address that meets
    every alignment that a launch holding it was chosen by (a pure
    function)."""
    return placeable(x, site) and aligned(x.ptr, site)


# ``ipt_graph_dispatch``'s steps
_WAIT, _LAUNCH, _RECORD = 1, 2, 4


class _Dispatch:
    """One instantiated graph's native dispatch (``ipt_graph_dispatch`` in
    ``csrc/graph_runtime.cu``): the kernel arguments that hold its input or
    output, grouped by node, each node's parameters taken once. A call, one
    call into the library, waits for the graph's last call where asked,
    points those arguments at the input and output given where they differ
    from what the graph holds (launches already enqueued keep theirs),
    launches the graph and records its event, as ``steps`` say. ``own``:
    the graph's own input and output addresses, which a call that binds
    neither passes, so that the graph's kernels read and write its own
    buffers again."""

    def __init__(self, graph: torch.cuda.CUDAGraph, inputs: Site | None, outputs: Site | None,
                 own_in: int, own_out: int):
        order = sorted([(0, b) for b in (inputs.bindings if inputs else ())]
                       + [(1, b) for b in (outputs.bindings if outputs else ())],
                       key=lambda rb: rb[1].node)
        n = len(order)
        build = _library()
        lib = build.library()
        handle = ctypes.c_void_p()
        build.check(lib.ipt_dispatch_new(
            graph.raw_cuda_graph_exec(), n, (ctypes.c_ulonglong * n)(*(b.node for _, b in order)),
            (ctypes.c_int * n)(*(b.nargs for _, b in order)),
            (ctypes.c_int * n)(*(b.index for _, b in order)),
            (ctypes.c_int * n)(*(role for role, _ in order)),
            (ctypes.c_ulonglong * n)(*(b.offset for _, b in order)), own_in, own_out,
            ctypes.byref(handle)), "ipt_dispatch_new")
        self.own = (own_in, own_out)
        self._handle, self._call, self._check = handle.value, lib.ipt_graph_dispatch, build.check
        weakref.finalize(self, lib.ipt_dispatch_free, handle.value)

    def __call__(self, stream: int, src: int, dst: int, event: int, steps: int) -> None:
        status = self._call(self._handle, stream, src, dst, event, steps)
        if status:
            self._check(status, "ipt_graph_dispatch")


@dataclasses.dataclass(eq=False)
class _Entry:
    """A kept graph, its input buffer, and an event recorded after its last
    call's outputs were read (calls on other streams wait for it). ``owner``
    (a weak reference, so that a dropped cache frees its graphs at once) and
    ``key``: the cache that holds it, so that the byte bound can drop it
    there; ``name``: its function's; ``seconds``: its capture's, the warm-up
    included; ``inputs`` and ``outputs``: where a caller's buffer may take
    the place of its input and output (``input_site``, ``output_site``),
    which ``dispatch`` points its kernels at; ``event``: ``done``'s CUDA
    event, and ``stream``: the stream that recorded it last (raw handles)."""

    static_in: torch.Tensor
    captured: Captured
    key: tuple = ()
    owner: weakref.ref | None = None
    name: str = ""
    seconds: float = 0.0
    done: torch.cuda.Event = dataclasses.field(default_factory=torch.cuda.Event)
    inputs: Site | None = None
    outputs: Site | None = None
    dispatch: _Dispatch | None = None
    event: int = 0
    stream: int | None = None

    @property
    def nbytes(self) -> int:
        return self.static_in.nbytes + self.captured.pool_bytes


# id(entry) -> a weak reference to it, least recently used first: a graph
# lives as long as the cache that owns it (a ``Graphed`` may be dropped).
_held: collections.OrderedDict = collections.OrderedDict()
captures_made = 0  # graphs captured and kept in this process, for reports
evictions_made = 0  # graphs dropped by the byte bound
replays_made = 0  # replays of kept graphs
upload_bytes = 0  # bytes copied from the host into graphs' inputs
inputs_bound = 0  # replays that read the caller's input where it lay
outputs_bound = 0  # replays that wrote the caller's output where it lies
copy_in_bytes = 0  # bytes copied card to card into graphs' inputs
copy_out_bytes = 0  # bytes copied card to card out of graphs' unbound outputs
dispatch_plans_made = 0  # plans ``Batched`` made for a batch on the card (``plan_key``)
dispatch_plan_hits = 0  # ``Batched`` calls that took a kept plan


def counts() -> dict:
    """The counters, as ``serve``'s ``serve_ok`` line names their deltas."""
    return {"graphs_captured": captures_made, "graphs_evicted": evictions_made,
            "graph_replays": replays_made, "upload_bytes": upload_bytes,
            "inputs_bound": inputs_bound, "outputs_bound": outputs_bound,
            "copy_in_bytes": copy_in_bytes, "copy_out_bytes": copy_out_bytes}


def _live() -> list:
    """The kept graphs still alive, least recently used first."""
    for key, ref in list(_held.items()):
        if ref() is None:
            del _held[key]
    return [ref() for ref in _held.values()]


def evictions(sizes: list, bound: int) -> int:
    """How many of the oldest graphs (``sizes``: their bytes, oldest first)
    to drop so that the rest hold at most ``bound`` bytes; the newest always
    stays (a pure function)."""
    total, k = sum(sizes), 0
    while k < len(sizes) - 1 and total > bound:
        total -= sizes[k]
        k += 1
    return k


def _keep(entry: _Entry) -> None:
    """Count a new graph against ``GRAPH_BYTES_BOUND``, dropping the least
    recently used ones (once their last call has finished) past it."""
    global captures_made, evictions_made
    captures_made += 1
    _held[id(entry)] = weakref.ref(entry)
    live = _live()
    k = evictions([e.nbytes for e in live], GRAPH_BYTES_BOUND)
    if not k:
        return
    evictions_made += k
    with profiling.span("graphs.evict"):
        for old in live[:k]:
            del _held[id(old)]
            old.done.synchronize()
            owner = old.owner() if old.owner is not None else None
            if owner is not None:
                owner.pop(old.key, None)
        torch.cuda.empty_cache()  # the dropped graphs' pools go back to the card


def _touch(entry) -> None:
    """Move a kept graph to the LRU's end."""
    if id(entry) in _held:
        _held.move_to_end(id(entry))


def _find(cache, key, make) -> _Entry:
    """The graph kept in ``cache`` (a weakly referenceable dict) for
    ``key``, made by ``make()`` and counted against the bound on a miss,
    moved to the LRU's end on a hit."""
    entry = cache.get(key)
    if entry is None:
        entry = cache[key] = make()
        _keep(entry)
    else:
        _touch(entry)
    return entry


def held() -> list:
    """The graphs kept now, least recently used first: each one's function,
    input shape, bytes and capture seconds."""
    return [{"fn": e.name, "input": tuple(e.static_in.shape), "bytes": e.nbytes,
             "capture_s": e.seconds} for e in _live()]


def _whole(out) -> Buffer | None:
    """``out`` where it is one tensor that is its storage's every byte."""
    if not isinstance(out, torch.Tensor) or _storage(out) != (out.data_ptr(), out.nbytes):
        return None
    return Buffer.of(out)


def _stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream (0: its default one)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _capture_entry(fn, x: torch.Tensor, key: tuple, cache, name: str) -> _Entry:
    """A graph of ``fn`` on a copy of ``x`` made on ``x``'s device, with the
    sites where a caller's buffers may take the place of its own and its
    native dispatch."""
    with profiling.span("graphs.capture"):
        t0 = time.perf_counter()
        static_in = torch.empty_like(x, device=torch.cuda.current_device())
        static_in.copy_(x)
        captured = capture(fn, static_in)
        own = Buffer.of(static_in)
        outs = [_storage(t) for t in pytree.tree_leaves(captured.out)
                if isinstance(t, torch.Tensor)]
        inputs = input_site(own, captured.notes, captured.touched, outs)
        whole = _whole(captured.out)
        outputs = output_site(whole, captured.notes, captured.touched, own,
                              captured.made.get(whole.ptr, 0) if whole is not None else 0)
        dispatch = _Dispatch(captured.graph, inputs, outputs, own.ptr,
                             captured.out.data_ptr() if outputs is not None else 0)
        entry = _Entry(static_in, captured, key, weakref.ref(cache), name,
                       time.perf_counter() - t0, inputs=inputs, outputs=outputs,
                       dispatch=dispatch)
        entry.done.record()  # makes the event that the library waits for and records
        entry.event, entry.stream = entry.done.cuda_event, _stream(static_in.device)
        return entry


def _replay(entry: _Entry, x: torch.Tensor, src: int | None, dst: int | None,
            stream: int) -> None:
    """One replay of ``entry`` on ``stream`` (the raw handle of the current
    stream on the graph's card), after the graph's last call: its input read
    at ``src`` where it lies in ``x`` (None: ``x`` copied into the graph's),
    its output written at ``dst`` (None: into the graph's own, which the
    caller reads, then ``_read``). A bound replay is one call into the
    library; a copied input's wait for the graph's last call comes before
    its copy."""
    global replays_made, upload_bytes, copy_in_bytes, inputs_bound, outputs_bound
    dispatch, event = entry.dispatch, entry.event
    own_in, own_out = dispatch.own
    at_in, at_out = own_in if src is None else src, own_out if dst is None else dst
    steps = _LAUNCH | (_WAIT if stream != entry.stream else 0) | (_RECORD if dst is not None else 0)
    if src is None:
        dispatch(stream, at_in, at_out, event, steps & _WAIT)
        steps &= ~_WAIT
        if x.is_cuda:
            copy_in_bytes += x.nbytes
        else:
            upload_bytes += x.nbytes
        with profiling.span("graphs.copy_in" if x.is_cuda else "graphs.upload"):
            entry.static_in.copy_(x)
    else:
        inputs_bound += 1
        if stream:  # the replay may read x after its caller frees it
            x.record_stream(torch.cuda.current_stream(x.device))
    outputs_bound += dst is not None
    replays_made += 1
    with profiling.span("graphs.replay"):
        dispatch(stream, at_in, at_out, event, steps)
    for wrapper, n in entry.captured.launches.items():
        wrapper.launches += n
    if dst is not None:
        entry.stream = stream


def _read(entry: _Entry, stream: int) -> None:
    """Mark the graph's static output read on ``stream``: its next call on
    another stream waits for this (a bound output's replay marks it itself)."""
    entry.done.record()
    entry.stream = stream


def _bound(x: torch.Tensor, site: Site | None) -> int | None:
    """``x``'s address where it may take the place of a graph's buffer at
    ``site`` for one replay (``bindable``), else None."""
    return x.data_ptr() if site is not None and bindable(Buffer.of(x), site) else None


@contextlib.contextmanager
def replayed(cache, key, fn, x: torch.Tensor, name: str):
    """One replay of the graph of ``fn`` that ``cache`` keeps for ``key``
    (captured on a copy of ``x`` made on the current card on a miss, and
    counted against the byte bound) on ``x`` (bound where ``bindable``, else
    copied in): its static output inside the block, which the graph's next
    call rewrites. Calls on other streams wait for the block's end."""
    entry = _find(cache, key, lambda: _capture_entry(fn, x, key, cache, name))
    stream = _stream(entry.static_in.device)
    try:
        _replay(entry, x, _bound(x, entry.inputs), None, stream)
        yield entry.captured.out
    finally:
        _read(entry, stream)


class Graphed:
    """``graphed(fn)``: ``fn`` as a compiled callable (see the module's docstring)."""

    def __init__(self, fn):
        self.fn = fn
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self.__name__ = _name(fn)
        self.__doc__ = fn.__doc__

    def __call__(self, x: torch.Tensor):
        if x.device.type != "cuda" or capturing():
            return self.fn(x)  # inside a capture, the outer graph captures the body
        key = graph_key(x)
        with torch.cuda.device(x.device):
            entry = _find(self._graphs, key,
                          lambda: _capture_entry(self.fn, x, key, self._graphs, self.__name__))
            stream = _stream(x.device)
            into = None if entry.outputs is None else torch.empty_like(
                entry.captured.out, memory_format=torch.contiguous_format)
            dst = None if into is None else _bound(into, entry.outputs)
            _replay(entry, x, _bound(x, entry.inputs), dst, stream)
            if dst is not None:
                return into
            out = _clone(entry.captured.out)
            _copied_out(entry.captured.out)
            _read(entry, stream)
            return out


graphed = Graphed


def group_size(image_bytes: int) -> int:
    """Images in one ``batched`` graph for images of ``image_bytes`` each:
    as many as ``GROUP_INPUT_BYTES`` hold, at least 1 and at most
    ``GROUP_IMAGES`` (10 at 4K RGB, 24,883,200 bytes an image; 43 at 1080p
    RGB; 341 at 512x512 RGB)."""
    return max(1, min(GROUP_IMAGES, GROUP_INPUT_BYTES // max(1, image_bytes)))


def spans(n: int, group: int) -> list:
    """(start, count) of each group of a batch of ``n`` images in groups of
    ``group``: ⌊n / group⌋ groups of ``group``, then one of the rest (a
    pure function)."""
    if n < 0 or group < 1:
        raise ValueError(f"spans: {n} images in groups of {group}")
    full = n // group * group
    return [(s, group) for s in range(0, full, group)] + ([(full, n - full)] if n > full else [])


def _each(fn, batch: torch.Tensor) -> list:
    """``fn`` on each image of ``batch`` in turn, eagerly: one output (a
    tensor or a tuple of tensors) per image."""
    return [fn(batch[i]) for i in range(batch.shape[0])]


def batch_form(single):
    """Declare the decorated function the batch form of ``single`` (see
    the module's docstring); returns it unchanged."""

    def declare(form):
        single.batch_form = form
        return form

    return declare


def batch_form_of(fn):
    """``fn``'s batch form, or None where it has none."""
    return getattr(fn, "batch_form", None)


def over_group(fn, batch: torch.Tensor):
    """``fn`` over one group of images: its batch form on the whole group
    (outputs stacked: a tensor, or a tuple), or where it has none ``fn`` on
    each image in turn (a list of per-image outputs)."""
    form = batch_form_of(fn)
    return _each(fn, batch) if form is None else form(batch)


def _stack(outs: list, out=None, row: int = 0):
    """Per-image outputs stacked along a new leading dimension (a tuple of
    stacks for tuple outputs): into fresh tensors, or into rows ``row`` on
    of ``out``."""
    if isinstance(outs[0], tuple):
        return tuple(_stack([o[k] for o in outs], None if out is None else out[k], row)
                     for k in range(len(outs[0])))
    if out is None:
        return torch.stack(outs)
    return torch.stack(outs, out=out[row:row + len(outs)])


def eager_batch(fn, batch: torch.Tensor):
    """The plain form of ``batched``: ``fn`` on each image of ``batch`` in
    turn, eagerly, on the batch's device, the outputs stacked along a new
    leading dimension (a tuple of stacks for tuple outputs)."""
    return _stack(_each(fn, batch))


def _empty_for(group, n: int, device, lead: int = 1):
    """Empty tensors on ``device`` for ``n`` images shaped as one group's
    outputs (``over_group``'s: a stack, a per-image list, or a tuple of
    these; or as this function gives them, on the meta device for a plan)."""
    if isinstance(group, torch.Tensor):
        return torch.empty((n, *group.shape[lead:]), dtype=group.dtype, device=device)
    if isinstance(group, tuple):
        return tuple(_empty_for(g, n, device, lead) for g in group)
    return _empty_for(group[0], n, device, 0)  # one image's outputs


def _put(group, out, row: int) -> None:
    """One group's outputs (as ``_empty_for`` takes them) into rows
    ``row`` on of ``out``: a stack in one copy, a per-image list stacked."""
    if isinstance(group, torch.Tensor):
        out[row:row + group.shape[0]].copy_(group)
    elif isinstance(group, tuple):
        for g, o in zip(group, out):
            _put(g, o, row)
    else:
        _stack(group, out, row)


# (fn, device, image shape, dtype, images) -> _Entry
_batch_graphs: collections.OrderedDict = collections.OrderedDict()


def plan_key(batch: torch.Tensor, device) -> tuple:
    """What a ``Batched`` plan is kept for: the device the batch runs on (as
    the caller names it) and the batch's own device, shape, dtype and
    strides (a pure function of the tensor's metadata)."""
    return (device, *graph_key(batch))


class _PlanGroup(NamedTuple):
    """One group of a plan: its first image and images, its graph (a weak
    reference), the bytes from the batch's start to the group's and from
    the output's start to its rows, and whether the group and its rows are
    ``placeable`` in the graph (then only their addresses decide a bind)."""

    start: int
    count: int
    entry: weakref.ref
    in_offset: int
    out_offset: int
    place_in: bool
    place_out: bool


class _Plan(NamedTuple):
    """What every call of ``Batched`` with one ``plan_key`` runs: the device
    it runs on, its outputs on the meta device (``_empty_for``: fresh
    tensors a call), the images of a group as ``group_size`` gave them for
    ``image_bytes``, the groups, and ``evictions_made`` when it was made."""

    device: torch.device
    out: object
    image_bytes: int
    group: int
    groups: tuple
    evictions: int

    def entries(self) -> list | None:
        """The groups' graphs, or None where the plan no longer holds: a graph
        was dropped (the byte bound dropped some since the plan was made, or
        one is gone), or a group would now hold another number of images."""
        if self.evictions != evictions_made or group_size(self.image_bytes) != self.group:
            return None
        entries = [g.entry() for g in self.groups]
        return None if None in entries else entries


class Batched:
    """``batched(fn)``: ``fn`` over a leading dimension (see the module's docstring)."""

    def __init__(self, fn):
        self.fn = fn
        self.__name__ = f"batched({_name(fn)})"
        self._plans = {}  # plan_key -> _Plan

        def body(x):
            return over_group(fn, x)

        body.__qualname__ = self.__name__
        self._body = body

    def __call__(self, images, device):
        """``fn`` on every image of ``images`` (uint8[N, ...]: numpy, or a
        tensor on any device) on ``device``: its outputs stacked (a tuple of
        stacks for tuple outputs), fresh tensors on ``device`` that no later
        call rewrites, as a JAX executable returns fresh arrays; serving
        downloads these (``serving._to_host``). On a card every call runs
        the plan kept for its ``plan_key`` while it holds
        (``_Plan.entries``), else a new one (``_plan``)."""
        global dispatch_plans_made, dispatch_plan_hits
        if not isinstance(device, torch.device) or device.index is None:
            device = torch.device(device)
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        batch = images if isinstance(images, torch.Tensor) else torch.as_tensor(images)
        if device.type != "cuda":
            return self._eager(batch, device)
        key = plan_key(batch, device)
        plan = self._plans.get(key)
        entries = None if plan is None else plan.entries()
        if entries is None:
            plan, entries = self._plan(batch, device)
            dispatch_plans_made += batch.is_cuda
            self._plans = {k: p for k, p in self._plans.items() if p.entries() is not None}
            self._plans[key] = plan
        else:
            dispatch_plan_hits += batch.is_cuda
        return self._run(plan, entries, batch)

    def _eager(self, batch: torch.Tensor, device: torch.device):
        """On a CPU device: each group's body run eagerly, its outputs copied."""
        n, out = batch.shape[0], None
        for start, count in spans(n, group_size(batch[0].nbytes)):
            with profiling.span("graphs.group"):
                outs = self._body(batch[start:start + count].to(device))
                out = _empty_for(outs, n, device) if out is None else out
                with profiling.span("graphs.copy_out"):
                    _put(outs, out, start)
        return out

    def _plan(self, batch: torch.Tensor, device: torch.device) -> tuple:
        """The plan of ``batch`` on ``device``, and its groups' graphs: each
        one found or captured (``_find``), none replayed. A group's input is
        placed where it lies on the graph's card; its rows of the output
        where the output is one tensor and the batch lies on the card."""
        n, group = batch.shape[0], group_size(batch[0].nbytes)
        entries = []
        with torch.cuda.device(device):
            for start, count in spans(n, group):
                part = batch[start:start + count]
                key = (self.fn, device, tuple(part.shape[1:]), part.dtype, count)
                entries.append(_find(_batch_graphs, key, lambda: _capture_entry(
                    self._body, part, key, _batch_graphs, self.__name__)))
        out = _empty_for(entries[0].captured.out, n, "meta")
        groups = []
        for (start, count), entry in zip(spans(n, group), entries):
            part = Buffer(batch.device, (count, *batch.shape[1:]), batch.stride(), 0, 0)
            place_out = isinstance(out, torch.Tensor) and batch.is_cuda and placeable(
                Buffer(device, (count, *out.shape[1:]), out.stride(), 0, 0), entry.outputs)
            groups.append(_PlanGroup(
                start, count, weakref.ref(entry), start * batch.stride(0) * batch.element_size(),
                start * out.stride(0) * out.element_size() if place_out else 0,
                placeable(part, entry.inputs), place_out))
        return _Plan(device, out, batch[0].nbytes, group, tuple(groups), evictions_made), entries

    def _run(self, plan: _Plan, entries: list, batch: torch.Tensor):
        """One call on ``plan``: fresh outputs, then one replay a group, its
        input and its rows of the output bound where the plan places them
        and their addresses are ``aligned``, else copied in (from the
        group's images) and out (before ``_read``)."""
        device = plan.device
        out = _empty_for(plan.out, batch.shape[0], device)
        stream, src = _stream(device), batch.data_ptr()
        dst = out.data_ptr() if isinstance(out, torch.Tensor) else 0
        current = torch.cuda.current_device() == device.index
        with contextlib.nullcontext() if current else torch.cuda.device(device):
            for g, entry in zip(plan.groups, entries):
                with profiling.span("graphs.group"):
                    _touch(entry)
                    at_in, at_out = src + g.in_offset, dst + g.out_offset
                    at_in = at_in if g.place_in and aligned(at_in, entry.inputs) else None
                    at_out = at_out if g.place_out and aligned(at_out, entry.outputs) else None
                    part = batch if at_in is not None else batch[g.start:g.start + g.count]
                    _replay(entry, part, at_in, at_out, stream)
                    if at_out is None:
                        with profiling.span("graphs.copy_out"):
                            _put(entry.captured.out, out, g.start)
                        _copied_out(entry.captured.out)
                        _read(entry, stream)
        return out


batched = Batched
