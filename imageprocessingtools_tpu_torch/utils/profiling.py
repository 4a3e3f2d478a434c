"""The port's own spans, and torch.profiler traces that show them.

Counterpart of ``imageprocessingtools_tpu/utils/profiling.py``. Usage:

    with recording() as rec:
        batched_fused_pipeline(images)
    [s.name for s in rec.spans]  # batch.apply, graphs.group, graphs.copy_in, ...

    with trace_to("traces") as prof:
        with span("flagship"):
            fused_pipeline_mega(img)
    events = profile_device.device_events(prof)

``span(name, id=None)`` marks a stage of the port where its work happens
(names are ``layer.stage``). While nothing records, it is one check of a
module global that returns a shared no-op: no clock read, no allocation.
Inside ``recording()``, each span is kept with its name, its request ``id``,
its parent (the span open around it on the same thread), its thread and its
start and end on ``time.perf_counter_ns()``. A span with no ``id`` takes its
parent's, and a root span with no ``id`` a fresh number. Any thread records:
serving's reader and writer do. Spans are kept in memory, at most ``CAP`` of
them; the rest are counted as dropped. One recording at a time.

``trace_to`` writes a Chrome trace (``trace-<ns>.json``) into the directory,
which Perfetto and ``chrome://tracing`` open, and yields the profiler, so
that ``profile_device.device_events`` and ``busy_us`` can read the same
run's device events (from that file, named by the profiler's
``chrome_trace``: a profile exports its trace only once). It records for its
block, and the trace holds each span as a complete event (``cat``
``"ipt_span"``, on its thread's ``tid``), moved onto the trace's clock by an
anchor: a ``record_function`` region taken inside the profile, paired with
the host clock. The spans are not ``record_function`` regions themselves:
those opened on another thread than the profiler's are missing from its
trace, and each costs a call into torch even with no profiler running.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch

CAP = 1 << 19  # spans a recording keeps (about 100 MB); later ones are counted as dropped
ANCHOR = "ipt_profiling.anchor"
ANCHORS = 3  # the first regions of a process pay one-time costs inside them; the shortest is used


class Span(NamedTuple):
    """One recorded span: ``seq`` numbers the spans of a recording in the
    order they opened, ``parent`` is the ``seq`` of the span open around it on
    its thread (None for a root), ``thread`` that thread's native id, and
    ``start`` and ``end`` are on ``time.perf_counter_ns()``."""

    seq: int
    name: str
    id: int | str
    parent: int | None
    thread: int
    start: int
    end: int


class _Thread(threading.local):
    """Per thread: its native id and the spans open on it, innermost last."""

    def __init__(self):
        self.tid = threading.get_native_id()
        self.stack = []


class Recording:
    """The spans recorded by one ``recording()`` block: ``spans`` (in the
    order they ended) and ``dropped`` (those past ``CAP``)."""

    def __init__(self, cap: int):
        # Plain tuples in ``Span``'s order: the garbage collector stops
        # tracking a tuple of numbers and strings, so that a long recording
        # does not lengthen its collections.
        self._kept: list[tuple] = []
        self.dropped = 0
        self._cap = cap
        self._lock = threading.Lock()
        self._thread = _Thread()
        self._seqs = itertools.count()
        self._ids = itertools.count()

    @property
    def spans(self) -> list[Span]:
        return [Span._make(t) for t in self._kept]

    def _keep(self, span: tuple) -> None:
        with self._lock:
            if len(self._kept) < self._cap:
                self._kept.append(span)
            else:
                self.dropped += 1


class _Open:
    """A span being recorded. Its ``id`` may be set inside its block, where
    the request is learnt there (an item taken from a queue)."""

    __slots__ = ("rec", "name", "id", "seq", "parent", "start", "thread")

    def __init__(self, rec: Recording, name: str, id):
        self.rec, self.name, self.id = rec, name, id

    def __enter__(self):
        rec = self.rec
        thread = self.thread = rec._thread
        stack = thread.stack
        parent = stack[-1] if stack else None
        self.parent = None if parent is None else parent.seq
        if self.id is None:
            self.id = next(rec._ids) if parent is None else parent.id
        self.seq = next(rec._seqs)
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        thread = self.thread
        thread.stack.pop()
        self.rec._keep((self.seq, self.name, self.id, self.parent, thread.tid, self.start, end))
        return False


class _NoSpan:
    """What ``span`` returns while nothing records: one shared object whose
    block does nothing, and whose ``id`` takes any value and keeps none."""

    __slots__ = ()
    id = property(lambda self: None, lambda self, value: None)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()
_recording: Recording | None = None
_start_lock = threading.Lock()


def span(name: str, id: int | str | None = None):
    """A context manager that records the stage ``name`` (``layer.stage``)
    of request ``id`` while a ``recording()`` is underway, and otherwise
    ``NO_SPAN``."""
    rec = _recording
    if rec is None:
        return NO_SPAN
    return _Open(rec, name, id)


@contextlib.contextmanager
def recording():
    """Record every span opened in the block, on any thread, into the
    ``Recording`` it yields. Raises ``RuntimeError`` inside another."""
    global _recording
    with _start_lock:
        if _recording is not None:
            raise RuntimeError("a recording of spans is underway already")
        rec = _recording = Recording(CAP)
    try:
        yield rec
    finally:
        _recording = None


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _anchor() -> list[int]:
    """``ANCHORS`` regions named ``ANCHOR``, each with the host clock read
    inside it."""
    read = []
    for _ in range(ANCHORS):
        with torch.profiler.record_function(ANCHOR):
            read.append(time.perf_counter_ns())
    return read


def _span_events(events: list[dict], spans: list[Span], read: list[int]) -> list[dict]:
    """``spans`` as Chrome trace complete events on the clock of ``events``
    (a trace that holds the anchor regions whose host clock ``read`` gives):
    the shortest region's middle is its reading."""
    regions = [e for e in events if e.get("name") == ANCHOR and e.get("ph") == "X"]
    if len(regions) != len(read):
        raise RuntimeError(f"the trace holds {len(regions)} anchor regions, not {len(read)}")
    regions.sort(key=lambda e: e["ts"])
    best = min(range(len(read)), key=lambda i: regions[i]["dur"])
    region = regions[best]
    shift = region["ts"] + region["dur"] / 2 - read[best] / 1e3
    return [{"ph": "X", "cat": "ipt_span", "name": s.name, "pid": region["pid"],
             "tid": s.thread, "ts": s.start / 1e3 + shift, "dur": (s.end - s.start) / 1e3,
             "args": {"id": s.id, "seq": s.seq, "parent": s.parent}}
            for s in spans]


def _add_spans(path: str, spans: list[Span], read: list[int]) -> None:
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    events.extend(_span_events(events, spans, read))
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Profile the with-block (the host, and the card where there is one),
    record its spans, and write its Chrome trace with the spans into
    ``log_dir``, also when the block raises. Work queued on the card inside
    the block is waited for before the profiler stops, so its events are in
    the trace."""
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    rec, read = None, []
    try:
        with prof, recording() as rec:
            read = _anchor()
            try:
                yield prof
            finally:
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
    finally:
        # A profile exports its trace once; readers take this file from here.
        prof.chrome_trace = os.path.join(log_dir, f"trace-{time.time_ns()}.json")
        prof.export_chrome_trace(prof.chrome_trace)
        if rec is not None:
            _add_spans(prof.chrome_trace, rec.spans, read)
