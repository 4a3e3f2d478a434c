"""torch.profiler integration: a trace of a block, and named regions in it.

Counterpart of ``imageprocessingtools_tpu/utils/profiling.py``. Usage:

    with trace_to("traces") as prof:
        with annotate("flagship"):
            fused_pipeline_mega(img)
    events = profile_device.device_events(prof)

``trace_to`` writes a Chrome trace (``trace-<ns>.json``) into the directory,
which Perfetto and ``chrome://tracing`` open, and yields the profiler, so
that ``profile_device.device_events`` and ``busy_us`` can read the same
run's device events (from that file, named by the profiler's
``chrome_trace``: a profile exports its trace only once).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Profile the with-block (the host, and the card where there is one)
    and write its Chrome trace into ``log_dir``, also when the block raises.
    Work queued on the card inside the block is waited for before the
    profiler stops, so its events are in the trace."""
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    try:
        with prof:
            try:
                yield prof
            finally:
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
    finally:
        # A profile exports its trace once; readers take this file from here.
        prof.chrome_trace = os.path.join(log_dir, f"trace-{time.time_ns()}.json")
        prof.export_chrome_trace(prof.chrome_trace)


def annotate(name: str):
    """A named region in the trace: a context manager or a decorator."""
    return torch.profiler.record_function(name)
