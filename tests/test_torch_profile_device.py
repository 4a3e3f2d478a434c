"""The device profiler's trace reading (``profile_device.py``), on the CPU.

The profile itself needs a CUDA card; these tests hold the parts that turn a
Chrome trace into device time: which events count, and the union of their
intervals. Exact: the inputs are integers of microseconds.
"""

from __future__ import annotations

import json

import pytest

from imageprocessingtools_tpu_torch import profile_device


class _FakeProfile:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _event(cat, ts, dur, name="k", ph="X"):
    return {"ph": ph, "cat": cat, "ts": ts, "dur": dur, "name": name}


def test_device_events_keeps_kernels_copies_and_memsets_only():
    events = [
        _event("kernel", 0, 5), _event("gpu_memcpy", 10, 3, "Memcpy HtoD (Pageable -> Device)"),
        _event("gpu_memset", 20, 1), _event("cpu_op", 0, 50), _event("cuda_runtime", 1, 2),
        _event("kernel", 30, 4, ph="i"),
    ]
    got = profile_device.device_events(_FakeProfile(events))
    assert [e["cat"] for e in got] == ["kernel", "gpu_memcpy", "gpu_memset"]


def test_device_events_without_device_activity_raises():
    with pytest.raises(RuntimeError, match="no device event"):
        profile_device.device_events(_FakeProfile([_event("cpu_op", 0, 50)]))


@pytest.mark.parametrize("spans, want", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (20, 5)], 15),          # apart
    ([(0, 10), (5, 10)], 15),          # overlapping
    ([(0, 10), (2, 3)], 10),           # nested
    ([(20, 5), (0, 10), (10, 10)], 25),  # unsorted, touching
])
def test_busy_us_is_the_union_of_intervals(spans, want):
    assert profile_device.busy_us([_event("kernel", ts, dur) for ts, dur in spans]) == want
