"""The ``print_ready_4k`` configuration on the port's CPU path at small sizes:
its plain reference equals the port through the path the cell times and the
JAX package's ``print_ready``, its control does not, its work is counted from
the shapes, ``dither_bound_pct`` reads the kernels it should, its cell loads,
and a whole small run is correct and fails under the control and the
faults."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from port_bench import frames, harness, spec, tracing
from port_bench.reference import print_ready_4k

CELL = "print_ready_4k.resident"
CONFIG = spec.load_json(spec.BENCH / "configs" / "print_ready_4k.json")


def small_cell(height=48, width=61, **workload):
    """``print_ready_4k.resident`` at ``height`` x ``width`` (rows that pad),
    the workload's counts cut, and ``workload`` over them."""
    cell = spec.cell(CELL)
    config = dict(cell.config, height=height, width=width)
    wl = dict(cell.workload, group=2, groups=2, keep=4, stretch=2)
    wl.update(workload)
    return dataclasses.replace(cell, config=config, workload=wl)


def run_small(tmp_path, substitute=None, device="cpu", seed=2**31 + 41, **workload):
    """One run of the small cell on ``device``; its result line's object."""
    workdir = tmp_path / f"run-{substitute}"
    workdir.mkdir()
    return harness.run_cell(small_cell(**workload), seed, 0.3, False, torch.device(device),
                            str(workdir), time.perf_counter(), substitute)


def _images(kind, seed=23):
    if kind == "flat":  # one bin holds every pixel: the identity LUT
        return torch.full((1, 20, 37, 3), 131, dtype=torch.uint8)
    h, w = kind
    return frames.frames(2, h, w, seed=seed, device="cpu")


@pytest.mark.parametrize("kind", [(48, 61), (64, 96), "flat"])
def test_reference_equals_the_port(on_cpu, kind):
    from imageprocessingtools_tpu_torch import serving
    from imageprocessingtools_tpu_torch.utils import graphs

    imgs = _images(kind)
    want = print_ready_4k.expected(imgs, CONFIG)
    assert want.shape == (*imgs.shape[:2], (imgs.shape[2] + 7) // 8)
    out, file_type = serving.process_batch(imgs, "print_ready")
    assert torch.equal(want, out) and file_type == 2  # P4
    one, _ = serving._task_fn("print_ready")  # the preset's batch form, then the packing
    assert torch.equal(want, graphs.batch_form_of(one)(imgs))
    assert torch.equal(want[0], one(imgs[0]))


def test_the_reference_dithers_as_the_c_indexes_its_matrix():
    """At level 200 a pixel is black where k * 255 / 16 > 200, k of 13 to 16,
    which lie at 1, 3, 9 and 11 of the C's flat matrix. Read at
    [(x % 4) * 4 + (y % 4)], they are pixels (y, x) = (1, 0), (3, 0), (1, 2)
    and (3, 2) of each 4 x 4 tile (row-major reading would give (0, 1), (0, 3),
    (2, 1) and (2, 3))."""
    bits = print_ready_4k.mono(torch.full((1, 8, 8, 3), 200, dtype=torch.uint8))[0]
    black = {(y, x) for y in range(8) for x in range(8) if bits[y, x]}
    assert black == {(y + dy, x + dx) for y, x in [(1, 0), (3, 0), (1, 2), (3, 2)]
                     for dy in (0, 4) for dx in (0, 4)}


@pytest.mark.parametrize("shape", [(64, 96), (135, 241)])
def test_the_bfloat16_control_differs(shape):
    imgs = frames.frames(2, *shape, seed=9, device="cpu")
    off = print_ready_4k.expected(imgs, CONFIG) != print_ready_4k.control(imgs, CONFIG)
    assert int(off.sum()) > 0


def test_the_reference_equals_the_jax_package_s_print_ready():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    from imageprocessingtools_tpu.models.presets import print_ready

    imgs = frames.frames(2, 48, 61, seed=31, device="cpu")
    want = print_ready_4k.expected(imgs, CONFIG)
    for img, packed in zip(imgs.numpy(), want.numpy()):
        bits = np.asarray(print_ready(jax.numpy.asarray(img)))
        assert np.array_equal(np.packbits(bits, axis=-1), packed)


def test_work_per_4k_image():
    work = spec.module("work", "print_ready_4k")
    p = 2160 * 3840
    stages = work.per_stage(CONFIG)
    assert stages["gray"] == {"bytes": 4 * p, "f64_ops": 0, "int_ops": 3 * p}
    assert stages["equalize"] == {"bytes": 3 * p, "f64_ops": 0, "int_ops": 2 * p}
    assert stages["dither"] == {"bytes": p, "f64_ops": 2 * p, "int_ops": 7 * p}
    assert stages["pack"] == {"bytes": 2160 * 480, "f64_ops": 0, "int_ops": 2 * p}
    whole = work.per_image(CONFIG)
    # the frame read once, the packed rows written once: 25.92 MB
    assert whole["bytes"] == 3 * p + 2160 * 480 == 25_920_000
    assert whole["f64_ops"] == 2 * p and whole["int_ops"] == 14 * p
    peaks = spec.load_json(spec.BENCH / "device" / "h100_sxm.json")
    # bound by its bytes: 7.74 us an image, the dither and packing 2.79 of it
    assert whole["bytes"] / peaks["bytes_per_s"] == pytest.approx(7.737e-6, rel=1e-3)
    pair = stages["dither"]["bytes"] + stages["pack"]["bytes"]
    assert pair / peaks["bytes_per_s"] == pytest.approx(2.785e-6, rel=1e-3)
    ops_s = (whole["f64_ops"] / peaks["f64_ops_per_s"]
             + whole["int_ops"] / peaks["int_ops_per_s"])
    assert ops_s < whole["bytes"] / peaks["bytes_per_s"]


def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_dither_bound_reads_every_kernel_but_the_named_stages(monkeypatch):
    cell = small_cell(height=2160, width=3840)
    run = harness.Run(cell, 1, 1.0, True, torch.device("cpu"), "")
    peaks = spec.load_json(spec.BENCH / "device" / "h100_sxm.json")
    monkeypatch.setattr(harness, "device_peaks", lambda device: peaks)
    named = [_ev("void (anonymous namespace)::elementwise_kernel<false>(unsigned char const*)",
                 0, 30),
             _ev("void (anonymous namespace)::histogram_kernel<true>(unsigned char const*)",
                 40, 20),
             _ev("(anonymous namespace)::lut_apply_kernel(unsigned char const*)", 70, 25)]
    others = [_ev("void at::native::vectorized_elementwise_kernel<4, at::native::"
                  "BinaryFunctor<short, short, short>>(int, short*)", 100, 300),
              _ev("void at::native::elementwise_kernel<128, 2>(int)", 450, 90),
              _ev("void (anonymous namespace)::elementwise_kernel_with_index<int, at::native::"
                  "arange_cuda_out(c10::Scalar const&)>(long)", 560, 10),
              _ev("Memcpy DtoD (Device -> Device)", 600, 50, "gpu_memcpy")]
    run.stretch = tracing.Stretch(units=2, images=3, window_us=1000.0, gaps=[],
                                  events=named + others)
    stages = spec.module("work", "print_ready_4k").per_stage(cell.config)
    least = (stages["dither"]["bytes"] + stages["pack"]["bytes"]) / peaks["bytes_per_s"]
    read = spec.module("metrics", "dither_bound_pct").read
    assert read(run) == pytest.approx(100 * least * 1e6 * 2 * 3 / 400)
    run.stretch.events = named + others[3:]  # nothing but the named stages' kernels
    assert read(run) is None
    run.stretch = None
    assert read(run) is None


def test_the_cell_loads_with_what_it_names():
    cell = spec.cell(CELL)
    assert cell.chips == 1 and cell.config["reduced"] == []
    assert {m["name"] for m in cell.end_to_end} == {"mpix_s", "call_ms_p95", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "kernel_bound_pct", "copy_us_per_image", "device_idle_pct.resident", "dither_bound_pct"}
    assert cell.workload["args"] == [cell.config["preset"]]
    assert callable(spec.entry(cell.workload["call"]))
    names = cell.workload["kernels"].values()
    # K8's name, and not torch's own elementwise kernels, arange's among them
    for torch_kernel in ("void at::native::elementwise_kernel<128, 2>(int)",
                         "void (anonymous namespace)::elementwise_kernel_with_index<int>(long)"):
        assert not any(n in torch_kernel for n in names)
    assert any(n in "void (anonymous namespace)::elementwise_kernel<false>(unsigned char const*)"
               for n in names)


def test_a_small_run_is_correct(on_cpu, tmp_path):
    line = run_small(tmp_path)
    assert line["correct"] is True and line["compared"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"mpix_s", "call_ms_p95", "setup_s"}
    assert line["checks"] == {"bytes_off": {"value": 0, "limit": 0}}


@pytest.mark.parametrize("substitute", ["control", "fault:alter", "fault:half", "fault:stale"])
def test_a_small_run_is_not_correct_under_the_control_and_faults(on_cpu, tmp_path, substitute):
    line = run_small(tmp_path, substitute)
    assert line["correct"] is False and line["checks"]["bytes_off"]["value"] > 0
