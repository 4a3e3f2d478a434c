"""The ``reference_4k`` configuration on the port's CPU path at small sizes:
its plain reference equals the port through the path the cell times, its
control does not, its work is counted from the geometry, its cell loads, and
a whole small run is correct and fails under the control and the faults."""

import dataclasses
import math
import time

import pytest
import torch

from port_bench import entries, frames, harness, spec, tracing
from port_bench.reference import reference_4k, rotate

CELL = "reference_4k.resident"
# A size at which the float32 control of the rotation differs from float64.
SMALL = {"height": 180, "width": 320, "new_width": 160}


def small_cell(height=SMALL["height"], width=SMALL["width"], new_width=SMALL["new_width"],
               **workload):
    """``reference_4k.resident`` at ``height`` x ``width`` -> ``new_width``:
    the configuration's sizes and flags and the workload's counts cut, and
    ``workload`` over them."""
    cell = spec.cell(CELL)
    flags = [f"-w{new_width}", *cell.config["flags"][1:]]
    config = dict(cell.config, height=height, width=width, new_width=new_width, flags=flags)
    wl = dict(cell.workload, args=[flags], group=2, groups=2, keep=4, stretch=2)
    wl.update(workload)
    return dataclasses.replace(cell, config=config, workload=wl)


def run_small(tmp_path, substitute=None, device="cpu", seed=2**31 + 29, **workload):
    """One run of the small cell on ``device``; its result line's object."""
    workdir = tmp_path / f"run-{substitute}"
    workdir.mkdir()
    return harness.run_cell(small_cell(**workload), seed, 0.3, False, torch.device(device),
                            str(workdir), time.perf_counter(), substitute)


def _config(new_width):
    return {"new_width": new_width, "angle": 30}


@pytest.mark.parametrize("shape", [(90, 160, 80), (91, 161, 81)])
def test_reference_equals_the_port(on_cpu, shape):
    from imageprocessingtools_tpu_torch import cli, serving
    from imageprocessingtools_tpu_torch.pipeline import run_pipeline_batch

    h, w, new_width = shape
    imgs = frames.frames(2, h, w, seed=21, device="cpu")
    want = reference_4k.expected(imgs, _config(new_width))
    flags = [f"-w{new_width}", "-r30", "-gray"]
    config, _ = cli._parse_args(flags + ["frame.ppm"])
    assert torch.equal(want, run_pipeline_batch(imgs, config)[0])
    assert torch.equal(want, serving.process_batch(imgs, config)[0])
    out, file_type = entries.reference_batch(imgs, flags)
    assert torch.equal(want, out) and file_type == config.file_type


@pytest.mark.parametrize("shape", [(180, 320, 160), (135, 241, 121)])
def test_the_float32_control_differs(shape):
    h, w, new_width = shape
    imgs = frames.frames(2, h, w, seed=9, device="cpu")
    cfg = _config(new_width)
    assert int((reference_4k.expected(imgs, cfg) != reference_4k.control(imgs, cfg)).sum()) > 0


@pytest.mark.parametrize("angle", [0, 30, 90, 135, 180, 270])
@pytest.mark.parametrize("shape", [(37, 53, 3), (29, 41, 1)])
def test_rotate_equals_the_port_s_plain_rotation(on_cpu, angle, shape):
    from imageprocessingtools_tpu_torch.ops.geometry import rotate as port_rotate

    imgs = frames.frames(2, *shape[:2], seed=angle + 3, device="cpu")[..., :shape[2]]
    got = rotate.rotate(imgs, angle, rows=8)  # several row blocks
    want = torch.stack([port_rotate(img.contiguous(), angle) for img in imgs])
    assert torch.equal(got, want)
    assert got.shape[1:3] == rotate.out_size(shape[0], shape[1], angle)


def _c_map(height, width, angle, x, y):
    """The C's inverse map of output pixel (y, x), one pixel at a time."""
    new_w, new_h = rotate.calc_rot_size(rotate.fold(angle), width, height)
    theta = (angle * math.pi) / 180.0
    xc, yc = width // 2, height // 2
    x0, y0 = float(x - (new_w // 2 - xc) - xc), float(y - (new_h // 2 - yc) - yc)
    n_x = ((math.cos(theta) * x0) + (math.sin(theta) * y0)) + xc
    n_y = ((-math.sin(theta) * x0) + (math.cos(theta) * y0)) + yc
    return n_x, n_y


def test_work_matches_a_hand_count():
    config = {"height": 12, "width": 16, "channels": 3, "new_width": 10, "angle": 30}
    work = spec.module("work", "reference_4k")
    # -w10 of 12 x 16: scale 0.625 both ways, new height int(12 * 0.625) = 7
    rh, rw = 7, 10
    new_w, new_h = rotate.calc_rot_size(30.0, rw, rh)
    interior = 0
    for y in range(new_h):
        for x in range(new_w):
            n_x, n_y = _c_map(rh, rw, 30.0, x, y)
            r_x, r_y = math.floor(n_x + 0.5), math.floor(n_y + 0.5)
            interior += 2 <= r_x <= rw - 3 and 2 <= r_y <= rh - 3
    assert interior == work.interior_pixels(rh, rw, 30.0) > 0
    stages = work.per_stage(config)
    assert stages["rotate"]["f64_ops"] == (2 * (new_h + new_w) + 6 * new_h * new_w
                                           + interior * (2 * 32 + 35 * 3))
    assert stages["rotate"]["bytes"] == rh * rw * 3 + new_h * new_w * 3
    assert stages["gray"]["int_ops"] == 3 * new_h * new_w
    thumb = spec.module("work", "thumbnail_4k").per_image(dict(config, new_width=10))
    assert stages["resize"]["f64_ops"] == thumb["f64_ops"]
    whole = work.per_image(config)
    assert whole["bytes"] == 12 * 16 * 3 + new_h * new_w
    assert whole["f64_ops"] == thumb["f64_ops"] + stages["rotate"]["f64_ops"]
    assert whole["int_ops"] == 3 * new_h * new_w


def test_the_cell_loads_with_what_it_names():
    cell = spec.cell(CELL)
    assert cell.chips == 1 and cell.config["reduced"] == []
    assert {m["name"] for m in cell.end_to_end} == {"mpix_s", "call_ms_p95", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "kernel_bound_pct", "copy_us_per_image", "device_idle_pct.resident", "rotate_bound_pct"}
    assert cell.workload["args"] == [cell.config["flags"]]
    config = entries._config(tuple(cell.config["flags"]))
    assert (config.new_width, config.angle, config.gray) == (
        cell.config["new_width"], cell.config["angle"], True)
    assert callable(spec.entry(cell.workload["call"]))
    # 4K -> 1920 x 1080 -> 2203 x 1895 at 30 degrees: P5-ready uint8[1895, 2203]
    assert rotate.out_size(1080, 1920, 30) == (1895, 2203)


def test_a_small_run_is_correct(on_cpu, tmp_path):
    line = run_small(tmp_path)
    assert line["correct"] is True and line["compared"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"mpix_s", "call_ms_p95", "setup_s"}
    assert line["checks"] == {"bytes_off": {"value": 0, "limit": 0}}


@pytest.mark.parametrize("substitute", ["control", "fault:alter", "fault:half", "fault:stale"])
def test_a_small_run_is_not_correct_under_the_control_and_faults(on_cpu, tmp_path, substitute):
    line = run_small(tmp_path, substitute)
    assert line["correct"] is False and line["checks"]["bytes_off"]["value"] > 0


def _ev(name, ts, dur):
    return {"ph": "X", "name": name, "cat": "kernel", "ts": ts, "dur": dur}


def test_rotate_bound_reads_the_rotation_kernels_alone(monkeypatch):
    cell = small_cell()
    run = harness.Run(cell, 1, 1.0, True, torch.device("cpu"), "")
    peaks = spec.load_json(spec.BENCH / "device" / "h100_sxm.json")
    monkeypatch.setattr(harness, "device_peaks", lambda device: peaks)
    run.stretch = tracing.Stretch(units=2, images=3, window_us=1000.0, gaps=[], events=[
        _ev("void rotate_kernel<3, true>(unsigned char const*)", 0, 40),
        _ev("void rotate_kernel<3, true>(unsigned char const*)", 500, 40),
        _ev("pass_rows_kernel", 100, 300), _ev("elementwise_kernel", 450, 10)])
    work = spec.module("work", "reference_4k").per_stage(cell.config)["rotate"]
    least = max(work["bytes"] / peaks["bytes_per_s"], work["f64_ops"] / peaks["f64_ops_per_s"])
    read = spec.module("metrics", "rotate_bound_pct").read
    assert read(run) == pytest.approx(100 * least * 1e6 * 2 * 3 / 80)
    run.stretch.events = run.stretch.events[2:]  # K1 fused away: nothing to read
    assert read(run) is None
    run.stretch = None
    assert read(run) is None
