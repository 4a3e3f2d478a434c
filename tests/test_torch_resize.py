"""The port's resize (``ops/resize.py``, ``kernels/resize.py``) on the CPU.

Inputs come from numpy seeds and go through both packages. Held against:

- the numpy golden model (``golden.resize_width``, ``_apply_contributions``;
  verified byte-identical to the C by tests/test_golden_vs_c.py), which is
  also the JAX package's ``resize_width_exact``: byte-equal, no tolerance.
  The port's passes are f64 sums in the C's tap order;
- the JAX package's device path (``resize_width``, ``resize``: float32 matrix
  products): within that package's ``float_stage_budget(True, False)`` = 2,
  the inexact side being JAX's.

On the CPU ``resize_pass`` takes K9's plain version; the kernel itself is
held to the plain version on the card by tests/test_torch_kernels_cuda.py.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu.golden import model as golden
from imageprocessingtools_tpu.ops import _exact as jax_exact
from imageprocessingtools_tpu.ops.common import float_stage_budget as jax_budget
import imageprocessingtools_tpu_torch as port
from imageprocessingtools_tpu_torch.kernels import _build
from imageprocessingtools_tpu_torch.kernels import resize as k9
from imageprocessingtools_tpu_torch.ops import _exact

# ``from ...ops import resize`` would give the function both packages export.
jax_resize = importlib.import_module("imageprocessingtools_tpu.ops.resize")
resize_ops = importlib.import_module("imageprocessingtools_tpu_torch.ops.resize")

JAX_BUDGET = jax_budget(True, False)  # 2: JAX's two float32 passes

# (shape, new width): down- and upscales, RGB and 2-D gray, odd sizes, fewer
# source pixels than taps (5x7 -> 2, 3x3 -> 40), one row upscaled, a
# one-pixel-wide image, a downscale with more taps than a staged chunk.
GEOMETRIES = [
    ((48, 64, 3), 32), ((48, 64, 3), 100), ((48, 64, 3), 64), ((37, 53, 3), 32),
    ((37, 53), 32), ((37, 53), 77), ((29, 7, 3), 5), ((5, 7, 3), 2), ((3, 3, 3), 40),
    ((1, 64, 3), 128), ((1, 64), 128), ((64, 1, 3), 3), ((40, 400, 3), 20), ((13, 17), 16),
]
# One that the JAX package routes to its host path (its dense matrix would
# pass 2^28 elements): 2 x 20000 -> 14000 (14000 x 20000 weights), one row out.
EXTREME = ((2, 20000, 3), 14000)


def _image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _max_diff(a, b):
    assert a.shape == b.shape
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max(initial=0))


@pytest.mark.parametrize("fn", [port.resize_width, port.resize_width_exact],
                         ids=["resize_width", "resize_width_exact"])
@pytest.mark.parametrize("shape,new_width", GEOMETRIES, ids=str)
def test_resize_width_byte_equal_to_golden(shape, new_width, fn):
    img = _image(shape, seed=sum(shape) + new_width)
    exp = np.asarray(jax_resize.resize_width_exact(img, new_width))
    out = fn(torch.from_numpy(img), new_width)
    assert out.dtype == torch.uint8 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), exp)


def test_resize_width_extreme_aspect_byte_equal_to_golden():
    shape, new_width = EXTREME
    assert jax_resize._dense_infeasible(shape[0], shape[1], new_width)
    img = _image(shape, seed=11)
    exp = golden.resize_width(img, new_width)
    for fn in (port.resize_width, port.resize_width_exact):
        np.testing.assert_array_equal(fn(torch.from_numpy(img), new_width).numpy(), exp)
    # the JAX default takes its host path here, so it is exact too
    np.testing.assert_array_equal(np.asarray(jax_resize.resize_width(img, new_width)), exp)


@pytest.mark.parametrize("shape,new_width", GEOMETRIES, ids=str)
def test_resize_width_within_jax_budget_of_jax_default(shape, new_width):
    img = _image(shape, seed=sum(shape) + new_width)
    exp = np.asarray(jax_resize.resize_width(img, new_width))
    out = port.resize_width(torch.from_numpy(img), new_width).numpy()
    assert _max_diff(out, exp) <= JAX_BUDGET


HW_TARGETS = [
    ((40, 30, 3), (20, 90)), ((40, 30), (90, 20)), ((33, 47, 3), (33, 47)),
    ((400, 6, 3), (9, 300)), ((9, 9, 3), (1, 1)), ((1, 64), (2, 128)), ((5, 7, 3), (40, 2)),
]


@pytest.mark.parametrize("shape,target", HW_TARGETS, ids=str)
def test_resize_byte_equal_to_golden_passes_and_near_jax(shape, target):
    img = _image(shape, seed=sum(shape) + sum(target))
    exp = img
    for dim, contrib in jax_resize._hw_passes(shape[0], shape[1], *target):
        exp = golden._apply_contributions(exp, contrib, dim)
    out = port.resize(torch.from_numpy(img), *target).numpy()
    np.testing.assert_array_equal(out, exp)
    assert out.shape[:2] == target
    assert _max_diff(out, np.asarray(jax_resize.resize(img, *target))) <= JAX_BUDGET


def test_hw_passes_identical_to_jax():
    for h, w, nh, nw in [(40, 30, 20, 90), (40, 30, 90, 20), (7, 7, 7, 7), (5, 300, 50, 3)]:
        ours, theirs = k9.hw_passes(h, w, nh, nw), jax_resize._hw_passes(h, w, nh, nw)
        assert [dim for dim, _ in ours] == [dim for dim, _ in theirs]
        for (_, a), (_, b) in zip(ours, theirs):
            np.testing.assert_array_equal(a.indices, b.indices)
            np.testing.assert_array_equal(a.weights, b.weights)


@pytest.mark.parametrize("args", [(0, 5), (5, 0), (-1, 5), (2**26 + 1, 1), (2**16, 2**16)],
                         ids=str)
def test_resize_error_messages_equal_jax(args):
    img = _image((4, 4, 3), seed=0)
    with pytest.raises(ValueError) as jax_err:
        jax_resize.resize(img, *args)
    with pytest.raises(ValueError) as port_err:
        port.resize(torch.from_numpy(img), *args)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("shape,new_width", [((4, 18, 3), 2), ((200, 10, 3), 999999999),
                                             ((4, 4, 3), 0), ((4096, 1, 3), 1048576)], ids=str)
def test_resize_width_b7_b9_errors_equal_jax(shape, new_width):
    img = _image(shape, seed=0)
    for jax_fn, port_fn in ((jax_resize.resize_width, port.resize_width),
                            (jax_resize.resize_width_exact, port.resize_width_exact)):
        with pytest.raises(ValueError) as jax_err:
            jax_fn(img, new_width)
        with pytest.raises(ValueError) as port_err:
            port_fn(torch.from_numpy(img), new_width)
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("shape,out_size", [((24, 31, 3), 10), ((24, 31), 50), ((3, 4, 3), 9),
                                            ((31, 24, 1), 7)], ids=str)
def test_resize_pass_plain_byte_equal_to_golden(shape, out_size, dim):
    img = _image(shape, seed=sum(shape) + out_size)
    in_size = shape[dim]
    contrib = jax_exact.calc_contributions(in_size, out_size, out_size / in_size)
    exp = golden._apply_contributions(img, contrib, dim)
    idx = torch.from_numpy(contrib.indices.astype(np.int32))
    w = torch.from_numpy(contrib.weights)
    for fn in (k9.resize_pass_plain, k9.resize_pass):
        out = fn(torch.from_numpy(img), idx, w, dim)
        assert out.dtype == torch.uint8
        np.testing.assert_array_equal(out.numpy(), exp)


def test_resize_pass_plain_sums_in_the_tables_order():
    """Weights (2^60, 1, -2^60) on equal pixels lose the middle term; in the
    order (2^60, -2^60, 1) they keep it. Indices repeat and run backwards."""
    img = torch.full((3, 5, 3), 200, dtype=torch.uint8)
    idx = torch.tensor([[2, 1, 0, 0], [0, 0, 1, 2]], dtype=torch.int32)
    big = 2.0 ** 60
    w = torch.tensor([[big, 1.0, -big, 0.0], [big, -big, 1.0, 0.0]], dtype=torch.float64)
    out = k9.resize_pass_plain(img, idx, w, 0)
    assert int(out[0].max()) == 0 and int(out[1].min()) == 200
    contrib = jax_exact.Contributions(indices=idx.numpy().astype(np.int64), weights=w.numpy())
    np.testing.assert_array_equal(out.numpy(),
                                  golden._apply_contributions(img.numpy(), contrib, 0))


@pytest.mark.parametrize("shape,new_width", [((48, 64, 3), 32), ((48, 64, 3), 100),
                                             ((37, 53), 32), ((5, 7, 3), 2)], ids=str)
def test_resize_width_dense_within_two_of_resize_width(shape, new_width):
    """The yardstick computes the same function in float32: each quantized
    pass may round one step the other way, and the second can stack (2)."""
    img = torch.from_numpy(_image(shape, seed=3))
    dense = resize_ops.resize_width_dense(img, new_width)
    exact = port.resize_width(img, new_width)
    assert dense.dtype == torch.uint8 and dense.shape == exact.shape
    assert _max_diff(dense.numpy(), exact.numpy()) <= 2


def test_cpu_tensor_never_touches_the_kernel_library(monkeypatch):
    def boom():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_build, "library", boom)
    img = torch.from_numpy(_image((20, 30, 3), seed=1))
    before = k9.resize_pass.launches
    port.resize_width(img, 12)
    port.resize(img, 8, 50)
    port.resize_width_exact(img[:, :, 0].contiguous(), 45)
    assert k9.resize_pass.launches == before


def test_resize_pass_refuses_other_devices_and_dims():
    meta = torch.empty((4, 4, 3), dtype=torch.uint8, device="meta")
    idx = torch.zeros((2, 2), dtype=torch.int32)
    w = torch.zeros((2, 2), dtype=torch.float64)
    with pytest.raises(TypeError, match="unsupported device"):
        k9.resize_pass(meta, idx, w, 0)
    with pytest.raises(ValueError, match="dim must be 0 or 1"):
        k9.resize_pass(torch.zeros((4, 4, 3), dtype=torch.uint8), idx, w, 2)


def test_device_tables_are_made_once_per_geometry(monkeypatch):
    calls = []
    real = _exact.calc_contributions

    def counting(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(_exact, "calc_contributions", counting)
    k9.device_passes.cache_clear()
    img = torch.from_numpy(_image((21, 33, 3), seed=2))
    first = port.resize_width(img, 13)
    assert len(calls) == 2  # one table per pass
    again = port.resize_width(torch.from_numpy(_image((21, 33, 3), seed=3)), 13)
    port.resize_width_exact(img, 13)
    assert len(calls) == 2 and again.shape == first.shape
    port.resize(img, 8, 13)  # another target: its own tables
    assert len(calls) == 4
    port.resize(img, 8, 13)
    assert len(calls) == 4
    passes = k9.device_passes(21, 33, 13, torch.device("cpu"))
    assert [(t.dtype, w.dtype) for _, t, w in passes] == [(torch.int32, torch.float64)] * 2
    assert all(t.is_contiguous() and w.is_contiguous() for _, t, w in passes)


def test_a_failed_plan_is_not_cached():
    for _ in range(2):
        with pytest.raises(ValueError, match="allocating ind2store"):
            port.resize_width(torch.zeros((4, 18, 3), dtype=torch.uint8), 2)


def test_gray_and_preset_reach_the_one_entry_point(monkeypatch):
    """``-wN`` on a 2-D gray tensor and the ``thumbnail`` preset go through
    ``resize_pass``, two passes each."""
    from imageprocessingtools_tpu_torch import models, pipeline

    monkeypatch.setenv("IPT_DEVICE", "cpu")
    seen = []
    real = k9.resize_pass

    def spy(img, idx, w, dim):
        seen.append((tuple(img.shape), dim))
        return real(img, idx, w, dim)

    monkeypatch.setattr(k9, "resize_pass", spy)
    gray = torch.from_numpy(_image((300, 400), seed=4))
    out, _ = pipeline.run_pipeline(gray, pipeline.PipelineConfig(new_width=100))
    assert tuple(out.shape) == (75, 100) and len(seen) == 2
    rgb = torch.from_numpy(_image((300, 400, 3), seed=5))
    thumb = models.get_preset("thumbnail")(rgb)
    assert tuple(thumb.shape) == (192, 256, 3) and len(seen) == 4
    np.testing.assert_array_equal(thumb.numpy(), golden.resize_width(rgb.numpy(), 256))
