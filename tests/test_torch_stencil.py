"""The port's stencil ops (K5 and K7 plain versions on the CPU) against JAX.

The JAX side runs as its own suites run it on the CPU: ``ops.stencil`` and
the Pallas kernels in interpret mode. Tolerance: none, every comparison is
byte-identical (all stencils are integer-exact on both sides).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu.kernels import pallas_core
from imageprocessingtools_tpu.ops import stencil as jax_stencil
from imageprocessingtools_tpu_torch.kernels import core
from imageprocessingtools_tpu_torch.ops import stencil
from tests.conftest import make_gradient, make_image

_OPS = ["box_blur", "sharpen", "sobel", "gaussian_blur"]
_PALLAS = {
    "box_blur": pallas_core.box_blur_pallas,
    "sharpen": pallas_core.sharpen_pallas,
    "sobel": pallas_core.sobel_pallas,
    "gaussian_blur": pallas_core.gaussian_blur_pallas,
}
_LAUNCHES = {
    "box_blur": core.box_blur,
    "sharpen": core.sharpen,
    "sobel": core.sobel,
    "gaussian_blur": core.gaussian_blur,
}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPT_DEVICE", "cpu")


def _gray(shape, seed=0):
    return make_image(*shape, seed=seed)[:, :, 0].copy()


@pytest.mark.parametrize("shape", [(16, 40), (9, 17), (1, 5), (5, 1)])
@pytest.mark.parametrize("name", _OPS)
def test_stencil_matches_jax_and_pallas(name, shape):
    gray = _gray(shape)
    exp = np.asarray(getattr(jax_stencil, name)(gray))
    np.testing.assert_array_equal(np.asarray(_PALLAS[name](gray)), exp)
    before = _LAUNCHES[name].launches
    out = getattr(stencil, name)(torch.from_numpy(gray))
    assert _LAUNCHES[name].launches == before  # CPU: the plain version
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), exp)


@pytest.mark.parametrize("name", _OPS)
def test_stencil_extremes_and_colour_match_jax(name):
    """0/255 steps reach sharpen's clip and Sobel's largest magnitudes; an
    HWC input runs per channel, as the JAX op does."""
    edges = (_gray((12, 19), seed=3) > 127).astype(np.uint8) * 255
    rgb = make_gradient(7, 11)
    for img in (edges, rgb):
        exp = np.asarray(getattr(jax_stencil, name)(img))
        np.testing.assert_array_equal(getattr(stencil, name)(torch.from_numpy(img)).numpy(), exp)


def test_isqrt_round_matches_jax_everywhere():
    m = np.arange(0, 2**21 + 2**16, dtype=np.int32)
    exp = np.asarray(jax_stencil._isqrt_round(m))
    np.testing.assert_array_equal(stencil._isqrt_round(torch.from_numpy(m)).numpy(), exp)
    k = exp.astype(np.int64)
    assert np.all((k * k - k + 1 <= m) | (m == 0)) and np.all(m <= k * k + k)
