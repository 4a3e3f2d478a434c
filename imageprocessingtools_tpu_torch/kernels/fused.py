"""Flagship fused pipeline: grayscale -> 5x5 Gaussian -> histogram equalize.

Counterpart of ``imageprocessingtools_tpu/kernels/fused.py``. The three
forms map uint8[H, W, 3] to uint8[H, W] and give the same bytes:

- ``fused_pipeline``: the plain torch versions, stage by stage (the JAX
  package's ``fused_pipeline_xla``); it launches no kernel on any device;
- ``fused_pipeline_staged``: K5, K4, the equalization LUT, then K3 (the JAX
  package's ``fused_pipeline_pallas``);
- ``fused_pipeline_mega``: K2 (gray + Gaussian + histogram in one pass),
  the equalization LUT, then K3 (the JAX package's
  ``fused_pipeline_pallas_mega``).
"""

from __future__ import annotations

import math

import torch

from imageprocessingtools_tpu_torch.kernels import core
from imageprocessingtools_tpu_torch.ops.color import grayscale
from imageprocessingtools_tpu_torch.ops.histogram import _equalize_lut


def fused_pipeline(img: torch.Tensor) -> torch.Tensor:
    """uint8[H, W, 3] -> uint8[H, W] with the plain torch versions."""
    blurred = core.gaussian_blur_plain(grayscale(img))
    lut = _equalize_lut(core.histogram_plain(blurred), math.prod(blurred.shape))
    return core.lut_apply_plain(blurred, lut)


def fused_pipeline_staged(img: torch.Tensor) -> torch.Tensor:
    """uint8[H, W, 3] -> uint8[H, W] through K5, K4 and K3."""
    blurred = core.gaussian_blur(grayscale(img))
    lut = _equalize_lut(core.histogram(blurred), math.prod(blurred.shape))
    return core.lut_apply(blurred, lut)


def fused_pipeline_mega(img: torch.Tensor) -> torch.Tensor:
    """uint8[H, W, 3] -> uint8[H, W] through K2 and K3."""
    blurred, hist = core.gray_gauss_hist(img)
    lut = _equalize_lut(hist, math.prod(blurred.shape))
    return core.lut_apply(blurred, lut)
