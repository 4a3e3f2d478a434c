"""Device time from the profiler's trace, and host time in the port's stages.

``device_events``, ``busy_us``, ``lost_events`` and the retry in ``profiled``
are copies of ``imageprocessingtools_tpu_torch/profile_device.py``'s
arithmetic, and ``Stages`` of the wrapping in
``imageprocessingtools_tpu_torch/serving_turns.py``; they are copied and not
imported, so that a change to the program cannot move the yardstick.

A traced run profiles a short stretch of its window (``Stretch``): the device
events inside it, the host calls that ``Stages`` wrapped, mapped onto the
trace's clock by the stretch's own marker, and the idle gaps between device
events, each named by the innermost wrapped call open at its middle.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
import threading
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "port_bench.stretch"
ATTEMPTS = 3
NAME_CHARS = 160  # of a device operation's name in the breakdown (C++ templates run long)


def trace_events(prof) -> list[dict]:
    """Every complete ("X") event of a finished profile's Chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X"]


def device_events(events: list[dict]) -> list[dict]:
    """The device events (kernels, copies, memsets) among ``events``; raises
    where there is none."""
    found = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not found:
        raise RuntimeError("the profiler recorded no device event")
    return found


def busy_us(events: list[dict]) -> float:
    """Length of the union of the events' [ts, ts + dur) intervals, in us."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def lost_events(events: list[dict], per_call: dict[str, int], reps: int) -> dict[str, list[int]]:
    """``{name: [found, wanted]}`` for every event name whose count in
    ``events``, the trace of ``reps`` calls, is not ``reps`` times its count
    in one call (``per_call``). Empty when the trace is complete."""
    found = collections.Counter(e["name"] for e in events)
    return {name: [found[name], reps * per_call.get(name, 0)]
            for name in sorted(set(found) | set(per_call))
            if found[name] != reps * per_call.get(name, 0)}


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def profiled(fn, lead) -> tuple[list[dict], float]:
    """The trace events of one profile of ``lead()`` then ``fn()`` under the
    marker, and the host clock at the marker's start. A profile taken late
    in a process loses its first device events (seen on the card after tens
    of thousands of calls), so ``lead`` runs inside the profile and before
    the marker, and ``marked`` keeps the events inside the marker. The tracer
    has returned traces without device events after many profiles in one
    process; such a profile is taken again after a pause, ``ATTEMPTS`` times
    in all."""
    for attempt in range(ATTEMPTS):
        with torch.profiler.profile(activities=_activities()) as prof:
            lead()
            with torch.profiler.record_function(MARKER):
                t0 = time.perf_counter()
                fn()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        events = trace_events(prof)
        if any(e.get("cat") in DEVICE_CATS for e in events) or attempt == ATTEMPTS - 1:
            return events, t0
        time.sleep(0.5)
    raise AssertionError("unreachable")


class Stages:
    """Host seconds and calls in wrapped functions of the port, and each
    call's interval on the host clock. ``wrap`` replaces ``owner.attr`` with
    a timed wrapper; ``restore`` puts every original back. Calls may come from several
    threads (serving's reader)."""

    def __init__(self):
        self.seconds: dict[str, float] = collections.defaultdict(float)
        self.calls: collections.Counter = collections.Counter()
        self.spans: list[tuple[str, float, float]] = []
        self._lock = threading.Lock()
        self._saved: list[tuple] = []

    def wrap(self, owner, attr: str, name: str) -> None:
        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.record(name, t0, time.perf_counter())

        self._saved.append((owner, attr, fn))
        setattr(owner, attr, timed)

    def record(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.seconds[name] += t1 - t0
            self.calls[name] += 1
            self.spans.append((name, t0, t1))

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()


def _marker(events: list[dict]) -> tuple[float, float]:
    """[start, stop) of the marker, on the trace's clock."""
    m = next(e for e in events if e.get("name") == MARKER and e.get("cat") == "user_annotation")
    return m["ts"], m["ts"] + m["dur"]


def marked(events: list[dict]) -> list[dict]:
    """The device events that begin inside the marker; raises where there is none."""
    start, stop = _marker(events)
    return device_events([e for e in events if start <= e["ts"] < stop])


def _gaps(intervals: list[tuple[float, float]], start: float, stop: float) -> list:
    """The sub-intervals of [start, stop) that no interval covers."""
    gaps, at = [], start
    for a, b in sorted(intervals):
        if a > at:
            gaps.append((at, min(a, stop)))
        at = max(at, b)
        if at >= stop:
            break
    if at < stop:
        gaps.append((at, stop))
    return [(a, b) for a, b in gaps if b > a]


@dataclasses.dataclass
class Stretch:
    """The traced stretch of a window: ``units`` units of ``images`` images
    each, its device events clipped to it, and its idle gaps named."""

    units: int
    images: int
    window_us: float
    events: list
    gaps: list          # (name, us)

    @classmethod
    def read(cls, events: list[dict], t0: float, units: int, images: int,
             spans=()) -> "Stretch":
        """The stretch from a profile's ``events`` whose marker began at host
        clock ``t0``; ``spans`` are (name, t0, t1) on the host clock."""
        start, stop = _marker(events)
        inside = []
        for e in device_events(events):
            a, b = max(e["ts"], start), min(e["ts"] + e["dur"], stop)
            if b > a:
                inside.append({**e, "ts": a, "dur": b - a})
        shift = start - t0 * 1e6
        host = [(name, a * 1e6 + shift, b * 1e6 + shift) for name, a, b in spans]
        gaps = []
        for a, b in _gaps([(e["ts"], e["ts"] + e["dur"]) for e in inside], start, stop):
            mid = (a + b) / 2
            open_ = [(hb - ha, name) for name, ha, hb in host if ha <= mid < hb]
            gaps.append((min(open_)[1] if open_ else "harness", b - a))
        return cls(units, images, stop - start, inside, gaps)

    def busy_us(self) -> float:
        return busy_us(self.events)

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_us() / self.window_us)

    def us(self, cats: tuple) -> float:
        """Summed duration of the events of categories ``cats``, in us."""
        return sum(e["dur"] for e in self.events if e.get("cat") in cats)

    def breakdown(self, top: int = 10) -> dict:
        ops = collections.defaultdict(float)
        for e in self.events:
            ops[e["name"][:NAME_CHARS]] += e["dur"] / 1e6
        return {
            "device_ops": sorted(([n, s] for n, s in ops.items()), key=lambda x: -x[1])[:top],
            "idle_gaps": [[n, us / 1e6] for n, us in sorted(self.gaps, key=lambda g: -g[1])[:top]],
        }
