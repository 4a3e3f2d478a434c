"""The port's tracing (``utils/profiling.py``) on the CPU.

``span`` must cost one check and record nothing while nothing records, and
inside ``recording()`` keep each span's name, request id, parent, thread
and times, from any thread, up to a cap. ``trace_to`` must write a Chrome
trace that holds each span of its block, from any thread, on the trace's
own clock, also when the block raises, and hand
``profile_device.device_events`` the same run's trace. Device events need
the card: ``chip_smoke.py`` phase 7 reads them from a traced run there.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu_torch import profile_device
from imageprocessingtools_tpu_torch.parallel.batch import batch_apply
from imageprocessingtools_tpu_torch.utils import profiling
from imageprocessingtools_tpu_torch.utils.profiling import recording, span, trace_to


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPT_DEVICE", "cpu")


def _work():
    x = torch.arange(4096, dtype=torch.int32).reshape(64, 64)
    return (x * 3 + 1).sum()


def _trace(log_dir) -> list[dict]:
    files = [f for f in os.listdir(log_dir) if f.endswith(".json")]
    assert len(files) == 1, files
    with open(os.path.join(log_dir, files[0])) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def _spans(events, name: str) -> list[dict]:
    return [e for e in events if e.get("name") == name and e.get("cat") == "ipt_span"]


@pytest.mark.parametrize("form", ["context", "thread"])
def test_trace_to_writes_a_chrome_trace_with_the_annotation(tmp_path, form):
    """A span of the block is in the trace, on the tid of the thread that
    opened it: the profiler's own thread or another one."""
    name = f"ipt-test-{form}"
    tids = []

    def spanned():
        tids.append(threading.get_native_id())
        with span(name):
            _work()

    with trace_to(str(tmp_path)) as prof:
        if form == "context":
            spanned()
        else:
            t = threading.Thread(target=spanned)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    found = _spans(_trace(tmp_path), name)
    assert len(found) == 1 and found[0]["tid"] == tids[0]
    assert prof.chrome_trace == str(next(tmp_path.glob("trace-*.json")))


def test_trace_to_writes_the_trace_when_the_block_raises(tmp_path):
    with pytest.raises(ValueError, match="inside"):
        with trace_to(str(tmp_path)):
            with span("ipt-test-raised"):
                _work()
                raise ValueError("inside the traced block")
    assert len(_spans(_trace(tmp_path), "ipt-test-raised")) == 1


def test_device_events_read_the_written_trace(tmp_path):
    """A profile exports its trace once: ``device_events`` reads the file
    ``trace_to`` wrote. On the CPU it holds no device event."""
    with trace_to(str(tmp_path / "traces")) as prof:
        _work()
    with pytest.raises(RuntimeError, match="no device event"):
        profile_device.device_events(prof)


def test_trace_to_puts_spans_on_the_trace_clock(tmp_path):
    """A span and a ``record_function`` region around the same 5 ms sleep
    start within 0.2 ms of each other in the exported trace."""
    with trace_to(str(tmp_path)):
        with span("ipt-test-sleep"), torch.profiler.record_function("ipt-test-region"):
            time.sleep(0.005)
    events = _trace(tmp_path)
    (s,) = _spans(events, "ipt-test-sleep")
    (r,) = [e for e in events if e.get("name") == "ipt-test-region"]
    assert abs(s["ts"] - r["ts"]) < 200
    assert s["dur"] >= 5000 and s["args"]["parent"] is None


def test_span_without_a_recording_is_the_shared_no_op(monkeypatch):
    """While nothing records, ``span`` returns one shared object and reads no
    clock, also at the port's span sites (a batch on the CPU)."""

    def no_clock():
        raise AssertionError("a span read the clock")

    monkeypatch.setattr(profiling.time, "perf_counter_ns", no_clock)
    assert span("a") is span("b", id=3) is profiling.NO_SPAN
    with span("a") as s:
        s.id = 7  # kept nowhere
    assert s.id is None
    images = np.arange(2 * 4 * 6 * 3, dtype=np.uint8).reshape(2, 4, 6, 3)
    assert batch_apply(lambda x: x[..., 0] + 1, images).shape == (2, 4, 6)


def test_recording_keeps_names_parents_and_ids():
    with recording() as rec:
        with span("outer") as outer:
            with span("inner"):
                pass
            with span("given", id="req-9"):
                with span("deep"):
                    pass
        with span("second", id=41):
            pass
        with span("third"):
            pass
    got = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["inner", "deep", "given", "outer", "second", "third"]
    assert got["inner"].parent == got["given"].parent == got["outer"].seq == outer.seq
    assert got["deep"].parent == got["given"].seq and got["outer"].parent is None
    assert got["inner"].id == got["outer"].id  # inherited
    assert got["given"].id == got["deep"].id == "req-9"
    assert got["second"].id == 41
    assert got["third"].id != got["outer"].id  # a fresh number for a root
    assert all(s.start <= s.end and s.thread == threading.get_native_id() for s in rec.spans)
    assert got["outer"].start <= got["inner"].start <= got["inner"].end <= got["outer"].end
    assert rec.dropped == 0 and profiling._recording is None
    assert span("after") is profiling.NO_SPAN


def test_recording_takes_spans_from_every_thread():
    """Three threads, each with its own span open around a child: one span
    a thread, parents never across threads."""
    barrier = threading.Barrier(3)

    def body(k):
        with span("worker", id=k):
            barrier.wait(timeout=30)
            with span("child"):
                pass

    with recording() as rec:
        threads = [threading.Thread(target=body, args=(k,)) for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    workers = {s.id: s for s in rec.spans if s.name == "worker"}
    children = [s for s in rec.spans if s.name == "child"]
    assert sorted(workers) == [0, 1, 2] and len(children) == 3
    assert len({s.thread for s in workers.values()}) == 3
    for c in children:
        assert workers[c.id].seq == c.parent and workers[c.id].thread == c.thread


def test_recording_counts_spans_past_its_cap(monkeypatch):
    monkeypatch.setattr(profiling, "CAP", 5)
    with recording() as rec:
        for k in range(12):
            with span("s", id=k):
                pass
    assert [s.id for s in rec.spans] == [0, 1, 2, 3, 4] and rec.dropped == 7


def test_recording_inside_a_recording_raises():
    with recording() as rec:
        with pytest.raises(RuntimeError, match="underway"):
            with recording():
                pass
        with span("still"):
            pass
    assert [s.name for s in rec.spans] == ["still"]
    with recording() as again:  # the first one ended
        pass
    assert again.spans == []


def test_batch_apply_records_its_stages():
    """On the CPU one group: ``batch.apply`` around ``graphs.group`` around
    ``graphs.copy_out``."""
    images = np.zeros((3, 4, 6, 3), dtype=np.uint8)
    with recording() as rec:
        batch_apply(lambda x: x[..., 0], images)
    by = {s.name: s for s in rec.spans}
    assert sorted(by) == ["batch.apply", "graphs.copy_out", "graphs.group"]
    assert by["graphs.group"].parent == by["batch.apply"].seq
    assert by["graphs.copy_out"].parent == by["graphs.group"].seq
    assert len({s.id for s in rec.spans}) == 1


@pytest.mark.parametrize("recorded", [False, True])
def test_pipeline_stages_and_k1_plans_are_spans_only_inside_a_recording(monkeypatch, recorded):
    """``run_pipeline_batch``'s stages are ``pipeline.<stage>`` spans, and a
    K1 plan made for a new geometry (here by the plain rotation's row check
    and by a direct call) a ``rotate.plan`` span, counted once in
    ``rotate.plans_made``: the cached plan again adds nothing. Without a
    recording no span reads the clock and the count is the same."""
    from imageprocessingtools_tpu_torch.kernels import rotate
    from imageprocessingtools_tpu_torch.pipeline import PipelineConfig, run_pipeline_batch

    images = np.arange(2 * 12 * 16 * 3, dtype=np.uint8).reshape(2, 12, 16, 3)
    angle = 33.25 + recorded  # angles no other test plans
    config = PipelineConfig(new_width=10, angle=angle, gray=True, flip_h=True)
    before = rotate.plans_made

    def run():
        for _ in range(2):
            out, _ = run_pipeline_batch(images, config)
            rotate._device_plan(47, 61, angle, torch.device("cpu"))
        return out

    if recorded:
        with recording() as rec:
            out = run()
        by = [(s.name, s.parent) for s in rec.spans]
        stages = [(s.name, s.seq) for s in rec.spans if s.name.startswith("pipeline.")]
        assert [name for name, _ in stages] == 2 * ["pipeline.resize", "pipeline.rotate",
                                                    "pipeline.gray", "pipeline.flip_h"]
        # the first pipeline's rotation plans its geometry, then the direct call
        assert [b for b in by if b[0] == "rotate.plan"] == [("rotate.plan", stages[1][1]),
                                                            ("rotate.plan", None)]
    else:
        def no_clock():
            raise AssertionError("a span read the clock")

        monkeypatch.setattr(profiling.time, "perf_counter_ns", no_clock)
        out = run()
    assert out.shape == (2, 11, 12)  # 12 x 16 -> 7 x 10 -> 11 x 12
    assert rotate.plans_made == before + 2


@pytest.mark.parametrize("form", ["one image", "batch"])
def test_print_ready_s_dither_and_packing_are_spans(form):
    """print_ready as serving runs it (``serving._task``: the preset, then
    P4 packing) records ``dither.mono`` and then ``packing.p4`` inside a
    recording, once a call, the packing a sibling of the dither."""
    from imageprocessingtools_tpu_torch import serving
    from imageprocessingtools_tpu_torch.utils import graphs

    one, _ = serving._task_fn("print_ready")
    images = torch.arange(2 * 9 * 13 * 3, dtype=torch.int32).reshape(2, 9, 13, 3).to(torch.uint8)
    with recording() as rec:
        out = one(images[0]) if form == "one image" else graphs.batch_form_of(one)(images)
    spans = [s for s in rec.spans if s.name in ("dither.mono", "packing.p4")]
    assert [s.name for s in spans] == ["dither.mono", "packing.p4"]
    assert spans[0].end <= spans[1].start and spans[0].parent == spans[1].parent
    assert out.shape[-1] == 2  # 13 bits a row, padded to 2 bytes
