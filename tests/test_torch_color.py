"""The port's colour ops against the JAX package, over all 256 values.

Tolerance: none. Every op is integer-exact, and ``contrast`` goes through a
float64 LUT made on the host on both sides.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu.ops import color as jax_color
from imageprocessingtools_tpu_torch.ops import color

_ALL = np.arange(256, dtype=np.uint8).reshape(16, 16)


def _both(fn_name, *args):
    exp = np.asarray(getattr(jax_color, fn_name)(_ALL, *args))
    out = getattr(color, fn_name)(torch.from_numpy(_ALL), *args)
    assert out.dtype == torch.uint8 and tuple(out.shape) == _ALL.shape
    return out.numpy(), exp


def test_invert_matches_jax():
    np.testing.assert_array_equal(*_both("invert"))


@pytest.mark.parametrize("delta", [-300, -40, 0, 17, 255])
def test_brightness_matches_jax(delta):
    np.testing.assert_array_equal(*_both("brightness", delta))


@pytest.mark.parametrize("thresh", [0, 1, 128, 255, 256])
def test_threshold_matches_jax(thresh):
    np.testing.assert_array_equal(*_both("threshold", thresh))


@pytest.mark.parametrize("factor", [0.0, 0.5, 1.5, 3.0])
def test_contrast_matches_jax(factor):
    np.testing.assert_array_equal(color._contrast_lut(factor), jax_color._contrast_lut(factor))
    np.testing.assert_array_equal(*_both("contrast", factor))


def test_colour_ops_keep_hwc_shape():
    rgb = np.random.default_rng(1).integers(0, 256, size=(5, 7, 3), dtype=np.uint8)
    t = torch.from_numpy(rgb)
    for name, args in (("invert", ()), ("brightness", (9,)), ("threshold", (100,)),
                       ("contrast", (1.5,))):
        exp = np.asarray(getattr(jax_color, name)(rgb, *args))
        np.testing.assert_array_equal(getattr(color, name)(t, *args).numpy(), exp)
