"""K6 (gray fused into the 5x5 Gaussian) of the port against the JAX package, on the CPU.

``core.gray_gauss_plain`` and the CPU path of the wrapper ``core.gray_gauss``
are held to ``pallas_core.gray_gauss_pallas`` in interpret mode (as
tests/test_pallas_kernels.py runs the Pallas kernels on the CPU, with
``block_rows=8``), and the port's ``edge_detect``, which now runs K6 and
Sobel, to the JAX preset. Tolerance: none; every stage is integer-exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu import models as jax_models
from imageprocessingtools_tpu.kernels import pallas_core as pk
from imageprocessingtools_tpu_torch import models
from imageprocessingtools_tpu_torch.kernels import core
from tests.conftest import make_gradient, make_image


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPT_DEVICE", "cpu")


@pytest.mark.parametrize("shape", [(16, 128), (7, 128), (37, 53)])
def test_gray_gauss_plain_matches_pallas(shape):
    img = make_image(*shape, seed=11)
    exp = np.asarray(pk.gray_gauss_pallas(img, block_rows=8))
    out = core.gray_gauss_plain(torch.from_numpy(img))
    assert out.dtype == torch.uint8 and tuple(out.shape) == shape
    np.testing.assert_array_equal(out.numpy(), exp)


@pytest.mark.parametrize("shape", [(1, 1), (5, 17), (8, 40), (21, 9)])
def test_gray_gauss_wrapper_on_cpu_is_the_plain_version(shape):
    img = torch.from_numpy(make_image(*shape, seed=12))
    before = core.gray_gauss.launches
    out = core.gray_gauss(img)
    assert core.gray_gauss.launches == before  # CPU: no kernel
    assert torch.equal(out, core.gray_gauss_plain(img))
    assert torch.equal(out, core.gaussian_blur_plain(core.grayscale_plain(img)))


def test_gray_gauss_hist_plain_is_gray_gauss_and_its_histogram():
    img = torch.from_numpy(make_gradient(19, 33))
    blurred, hist = core.gray_gauss_hist_plain(img)
    assert torch.equal(blurred, core.gray_gauss_plain(img))
    assert torch.equal(hist, core.histogram_plain(blurred))


@pytest.mark.parametrize("kind", ["noise", "gradient"])
@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (7, 53), (37, 53)])
def test_edge_detect_matches_jax(shape, kind):
    img = make_image(*shape, seed=13) if kind == "noise" else make_gradient(*shape)
    exp = np.asarray(jax_models.get_preset("edge_detect")(img))
    out = models.get_preset("edge_detect")(torch.from_numpy(img))
    assert out.dtype == torch.uint8 and tuple(out.shape) == exp.shape
    np.testing.assert_array_equal(out.numpy(), exp)


def test_edge_detect_takes_a_view():
    img = make_image(12, 40, seed=14)
    view = torch.from_numpy(img)[:, ::2]  # not contiguous
    exp = np.asarray(jax_models.get_preset("edge_detect")(np.ascontiguousarray(img[:, ::2])))
    np.testing.assert_array_equal(models.get_preset("edge_detect")(view).numpy(), exp)
