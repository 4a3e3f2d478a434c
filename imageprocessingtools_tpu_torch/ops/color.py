"""Pointwise colour ops, all integer-exact.

Counterpart of ``imageprocessingtools_tpu/ops/color.py``. ``grayscale``
mirrors the reference op (``ppmx-edward.c:986-1003``): on a CUDA tensor it
launches K8 (``kernels/core.py::fused_elementwise``) with the empty chain,
which does in one pass what XLA's fusion does for the JAX package; on a CPU
tensor it runs the plain version. The rest are the JAX package's extension
ops, as int32 torch ops on any device, on gray or RGB input. ``contrast``
goes through a float64 LUT made on the host, so it is exact for any factor;
the LUT is uploaded once per factor and device, so that a CUDA graph can
capture it (``utils/graphs.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from imageprocessingtools_tpu_torch.kernels import core as _core
from imageprocessingtools_tpu_torch.utils import graphs


def grayscale(img: torch.Tensor) -> torch.Tensor:
    """uint8[..., 3] -> uint8[...]; exact integer (r+g+b)/3: K8 with the
    empty chain on CUDA (a view is made contiguous first), plain on CPU."""
    return _core.fused_elementwise(img.contiguous())


def invert(img: torch.Tensor) -> torch.Tensor:
    """255 - v, exact."""
    return (255 - img.to(torch.int32)).to(torch.uint8)


def brightness(img: torch.Tensor, delta) -> torch.Tensor:
    """clamp(v + delta) with integer delta; exact."""
    return (img.to(torch.int32) + delta).clamp(0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=64)
def _contrast_lut(factor: float) -> np.ndarray:
    """256-entry LUT computed on the host in float64, so the device gather is
    exact for any factor."""
    v = (np.arange(256, dtype=np.float64) - 128.0) * float(factor) + 128.0
    return np.clip(np.floor(v + 0.5), 0, 255).astype(np.uint8)


@graphs.device_table(maxsize=64)
def _contrast_table(factor: float, device: torch.device) -> torch.Tensor:
    """``_contrast_lut(factor)`` on ``device``, uploaded once per (factor, device)."""
    return torch.from_numpy(_contrast_lut(factor)).to(device)


def contrast(img: torch.Tensor, factor: float) -> torch.Tensor:
    """clamp(round_half_up((v - 128) * factor + 128)) through the host LUT."""
    lut = _contrast_table(float(factor), img.device)
    return lut[img.long()]


def threshold(img: torch.Tensor, thresh) -> torch.Tensor:
    """v >= thresh -> 255 else 0; exact."""
    return torch.where(img.to(torch.int32) >= thresh, 255, 0).to(torch.uint8)
