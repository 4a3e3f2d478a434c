"""The port's histogram, equalization and staged flagship against JAX.

K4's plain version (a bincount) and the staged pipeline run on the CPU; the
JAX side runs its ops and its Pallas kernels in interpret mode, as its own
suites do. Tolerance: none, every comparison is byte-identical (counts are
integers, and the equalization LUT is float32 in the same operation order
on both sides).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu.kernels import fused as jax_fused
from imageprocessingtools_tpu.kernels import pallas_core
from imageprocessingtools_tpu_torch.kernels import core, fused
from tests.conftest import make_gradient, make_image

# Both packages re-export a function named ``histogram`` from ``ops``, so the
# modules are taken by their full names.
jax_histogram = importlib.import_module("imageprocessingtools_tpu.ops.histogram")
histogram = importlib.import_module("imageprocessingtools_tpu_torch.ops.histogram")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPT_DEVICE", "cpu")


def _image(kind, shape):
    if kind == "noise":
        return make_image(*shape)
    if kind == "gradient":
        return make_gradient(*shape)
    return np.full(shape + (3,), 77, dtype=np.uint8)


@pytest.mark.parametrize("shape", [(16, 40), (9, 17), (1, 5), (130, 3)])
def test_histogram_plain_matches_pallas_and_jax(shape):
    gray = make_image(*shape)[:, :, 1].copy()
    exp = np.asarray(jax_histogram.histogram(gray))
    np.testing.assert_array_equal(np.asarray(pallas_core.histogram_pallas(gray)), exp)
    np.testing.assert_array_equal(core.histogram_plain(torch.from_numpy(gray)).numpy(), exp)
    before = core.histogram.launches
    np.testing.assert_array_equal(histogram.histogram(torch.from_numpy(gray)).numpy(), exp)
    assert core.histogram.launches == before  # CPU: the plain version


@pytest.mark.parametrize("kind", ["noise", "gradient", "constant"])
def test_equalize_histogram_matches_jax(kind):
    gray = _image(kind, (23, 37))[:, :, 0].copy()
    exp = np.asarray(jax_histogram.equalize_histogram(gray))
    out = histogram.equalize_histogram(torch.from_numpy(gray))
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), exp)


@pytest.mark.parametrize("kind", ["noise", "gradient", "constant"])
@pytest.mark.parametrize("shape", [(29, 130), (5, 17)])
def test_fused_staged_matches_pallas(shape, kind):
    img = _image(kind, shape)
    exp = np.asarray(jax_fused.fused_pipeline_pallas(img))
    t = torch.from_numpy(img)
    np.testing.assert_array_equal(fused.fused_pipeline_staged(t).numpy(), exp)
    np.testing.assert_array_equal(fused.fused_pipeline(t).numpy(), exp)


def test_histogram_count_guard():
    big = torch.zeros(1, dtype=torch.uint8).expand(2**31)  # one byte behind it
    with pytest.raises(ValueError, match="2\\^31"):
        core.histogram_plain(big)
