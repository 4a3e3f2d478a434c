"""The metric arithmetic on hand-made events and samples."""

import statistics

import pytest

from port_bench import harness, spec, stats, tracing


def ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def marker(ts, dur):
    return ev(tracing.MARKER, ts, dur, "user_annotation")


def test_p95_is_over_every_sample():
    values = list(range(1, 101))  # 1..100
    assert stats.p95(values) == pytest.approx(95.05)
    assert stats.p95([7.0]) == 7.0 and stats.p95([]) is None
    # one slow call in twenty moves the tail, not a median of chunks
    assert stats.p95([1.0] * 19 + [50.0]) > 3.0


def test_rate_is_over_the_whole_window():
    assert stats.rate(829.44, 0.5) == pytest.approx(1658.88)
    assert stats.rate(0, 1.0) is None and stats.rate(5, 0.0) is None


def test_spread_is_the_quartile_distance_over_the_median():
    values = [10.0, 10.5, 11.0, 9.5, 10.2, 9.8]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx((q3 - q1) / med)


def test_busy_is_the_union_of_intervals():
    events = [ev("a", 0, 10), ev("b", 5, 10), ev("c", 20, 5)]
    assert tracing.busy_us(events) == 20


def test_a_trace_that_lost_events_is_refused():
    per_call = {"k2": 1, "copy": 2}
    whole = [ev("k2", i, 1) for i in range(3)] + [ev("copy", i, 1, "gpu_memcpy") for i in range(6)]
    assert tracing.lost_events(whole, per_call, 3) == {}
    assert tracing.lost_events(whole[1:], per_call, 3) == {"k2": [2, 3]}
    # events that begin before the marker (the lead-in) are not the stretch's
    assert tracing.marked([ev("k2", 5, 1), marker(10, 10), ev("k2", 12, 1)]) == [ev("k2", 12, 1)]
    with pytest.raises(RuntimeError):
        tracing.device_events([marker(0, 10)])


def test_stretch_idle_share_gaps_and_breakdown():
    events = [marker(1000, 100), ev("k9", 1000, 30), ev("copy", 1040, 20, "gpu_memcpy"),
              ev("k9", 1090, 20), ev("cpu op", 1000, 100, "cpu_op")]
    # host clock 2.0 s is trace time 1000 us; "decode" is open over 1060-1090
    s = tracing.Stretch.read(events, 2.0, units=2, images=5,
                             spans=[("decode", 2.0 + 60e-6, 2.0 + 90e-6),
                                    ("pass", 2.0, 2.0 + 100e-6)])
    assert s.window_us == 100 and s.busy_us() == 60  # the last event is clipped at the end
    assert s.idle_pct() == pytest.approx(40.0)
    assert s.us(("kernel",)) == 40 and s.us(("gpu_memcpy", "gpu_memset")) == 20
    assert sorted(s.gaps) == [("decode", 30), ("pass", 10)]
    b = s.breakdown()
    assert b["device_ops"][0] == ["k9", pytest.approx(40e-6)]
    assert b["idle_gaps"][0] == ["decode", pytest.approx(30e-6)]


def test_per_layer_readers_on_a_hand_made_stretch(monkeypatch):
    cell = spec.cell("thumbnail_4k.resident")
    run = harness.Run(cell, 1, 1.0, True, None, "")
    run.stretch = tracing.Stretch(units=4, images=10, window_us=4000.0,
                                  events=[ev("k9", 0, 700), ev("k9", 1000, 700),
                                          ev("k9", 2000, 700), ev("k9", 3000, 700),
                                          ev("cp", 800, 150, "gpu_memcpy")], gaps=[])
    monkeypatch.setattr(harness.Run, "least_s", lambda self, images: images * 11.97e-6)
    read = lambda name: spec.module("metrics", name).read(run)  # noqa: E731
    assert read("kernel_bound_pct") == pytest.approx(100 * 119.7 / 700)
    assert read("copy_us_per_image") == pytest.approx(150 / 40)
    assert read("device_idle_pct.resident") == pytest.approx(100 * (1 - 2950 / 4000))


def test_host_readers_divide_by_the_window_s_answers():
    cell = spec.cell("thumbnail_4k.files")
    run = harness.Run(cell, 1, 1.0, True, None, "")
    run.stages = tracing.Stages()
    run.stages.record("serving._read_and_decode", 0.0, 0.64)
    run.stages.record("serving.process_batch", 0.0, 0.2)
    run.stages.record("serving._to_host", 0.0, 0.12)
    run.window.counts.update(files=64)
    assert spec.module("metrics", "decode_ms_per_file").read(run) == pytest.approx(10.0)
    assert spec.module("metrics", "transfer_ms_per_file").read(run) == pytest.approx(5.0)
    run.stages = tracing.Stages()
    assert spec.module("metrics", "decode_ms_per_file").read(run) is None  # nothing to read


def test_end_to_end_readers():
    run = harness.Run(spec.cell("flagship_4k.resident"), 1, 1.0, False, None, "")
    run.window.start, run.window.end, run.window.units = 10.0, 12.0, 4
    run.window.counts.update(mpix=4 * 82.944)
    run.window.samples["call_ms"].extend([0.5, 0.5, 0.5, 0.9])
    run.setup_s = 3.5
    assert spec.module("metrics", "mpix_s").read(run) == pytest.approx(2 * 82.944)
    assert spec.module("metrics", "call_ms_p95").read(run) == pytest.approx(0.84)
    assert spec.module("metrics", "setup_s").read(run) == 3.5
    assert spec.module("metrics", "files_s").read(run) is None


def test_stages_wrap_and_restore():
    class Owner:
        @staticmethod
        def f(x):
            return x + 1

    st = tracing.Stages()
    original = Owner.f
    st.wrap(Owner, "f", "owner.f")
    assert Owner.f(1) == 2 and st.calls["owner.f"] == 1 and len(st.spans) == 1
    st.restore()
    assert Owner.f is original
