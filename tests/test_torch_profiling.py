"""The port's tracing (``utils/profiling.py``) on the CPU.

``trace_to`` must write a Chrome trace that holds each ``annotate`` region by
name, in both of ``annotate``'s forms, also when the block raises, and hand
``profile_device.device_events`` the same run's trace. Device events need
the card: ``chip_smoke.py`` phase 5 reads them from a traced run there.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from imageprocessingtools_tpu_torch import profile_device
from imageprocessingtools_tpu_torch.utils.profiling import annotate, trace_to


def _work():
    x = torch.arange(4096, dtype=torch.int32).reshape(64, 64)
    return (x * 3 + 1).sum()


def _trace(log_dir) -> list[dict]:
    files = [f for f in os.listdir(log_dir) if f.endswith(".json")]
    assert len(files) == 1, files
    with open(os.path.join(log_dir, files[0])) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def _annotated(events, name: str) -> list[dict]:
    return [e for e in events if e.get("name") == name and e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("form", ["context", "decorator"])
def test_trace_to_writes_a_chrome_trace_with_the_annotation(tmp_path, form):
    name = f"ipt-test-{form}"
    with trace_to(str(tmp_path)) as prof:
        if form == "context":
            with annotate(name):
                _work()
        else:
            annotate(name)(_work)()
    events = _trace(tmp_path)
    assert len(_annotated(events, name)) == 1
    assert prof.chrome_trace == str(next(tmp_path.glob("trace-*.json")))


def test_trace_to_writes_the_trace_when_the_block_raises(tmp_path):
    with pytest.raises(ValueError, match="inside"):
        with trace_to(str(tmp_path)):
            with annotate("ipt-test-raised"):
                _work()
                raise ValueError("inside the traced block")
    assert len(_annotated(_trace(tmp_path), "ipt-test-raised")) == 1


def test_device_events_read_the_written_trace(tmp_path):
    """A profile exports its trace once: ``device_events`` reads the file
    ``trace_to`` wrote. On the CPU it holds no device event."""
    with trace_to(str(tmp_path / "traces")) as prof:
        _work()
    with pytest.raises(RuntimeError, match="no device event"):
        profile_device.device_events(prof)
