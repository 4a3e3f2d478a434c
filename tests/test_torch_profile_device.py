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


def _trace(per_call, reps, drop=None):
    """A synthetic trace of ``reps`` calls: each name ``per_call[name]``
    times per call, less ``drop[name]`` events lost."""
    events, ts = [], 0
    for name, n in per_call.items():
        for _ in range(reps * n - (drop or {}).get(name, 0)):
            events.append(_event("kernel", ts, 3, name))
            ts += 5
    return events


# One call of the flagship: K2, K3 and the LUT's torch kernels, some of them
# launched several times under one name.
_FLAGSHIP = {"gray_gauss_kernel<true, true>": 1, "lut_apply_kernel": 1,
             "vectorized_elementwise_kernel": 9, "cumsum_kernel": 1, "Memset (Device)": 1}


@pytest.mark.parametrize("per_call", [{"histogram_kernel": 1}, _FLAGSHIP], ids=["one", "flagship"])
def test_lost_events_passes_a_full_trace(per_call):
    reps = profile_device.REPS
    assert profile_device.lost_events(_trace(per_call, reps), per_call, reps) == {}


def test_lost_events_names_the_kernel_and_its_counts():
    reps = profile_device.REPS
    got = profile_device.lost_events(_trace({"sharpen": 1}, reps, {"sharpen": 14}),
                                     {"sharpen": 1}, reps)
    assert got == {"sharpen": [reps - 14, reps]}


def test_lost_events_checks_each_name_of_a_case_with_several_kernels():
    reps = profile_device.REPS
    drop = {"vectorized_elementwise_kernel": 3, "lut_apply_kernel": 1}
    got = profile_device.lost_events(_trace(_FLAGSHIP, reps, drop), _FLAGSHIP, reps)
    assert got == {"lut_apply_kernel": [reps - 1, reps],
                   "vectorized_elementwise_kernel": [9 * reps - 3, 9 * reps]}


def test_lost_events_reports_a_name_missing_from_either_side():
    """A kernel whose events were all lost, and one the single call lost."""
    reps = 4
    events = _trace({"a": 1, "c": 1}, reps)
    assert profile_device.lost_events(events, {"a": 1, "b": 2}, reps) == {
        "b": [0, 8], "c": [4, 0]}


def test_complete_trace_retries_then_stops_naming_the_case(monkeypatch):
    reps = profile_device.REPS
    full, short = _trace({"k": 1}, reps), _trace({"k": 1}, reps, {"k": 5})
    single = _trace({"k": 1}, 1)
    calls = []

    def profiled(traces):
        it = iter(traces)

        def fake(fn, attempts=profile_device.ATTEMPTS):
            calls.append(1)
            return next(it)
        return fake

    # Short once, then full: the second attempt's trace is returned.
    monkeypatch.setattr(profile_device, "_profiled", profiled([single, short, single, full]))
    assert profile_device._complete_trace("K7 sharpen", lambda: None) == full
    assert len(calls) == 4
    # Short every time: the run stops and names the case and the counts.
    monkeypatch.setattr(profile_device, "_profiled",
                        profiled([single, short] * profile_device.ATTEMPTS))
    with pytest.raises(SystemExit, match=rf"'K7 sharpen'.*\[{reps - 5}, {reps}\]"):
        profile_device._complete_trace("K7 sharpen", lambda: None)
