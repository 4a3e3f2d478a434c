"""Pointwise colour ops, all integer-exact.

Counterpart of ``imageprocessingtools_tpu/ops/color.py``. ``grayscale``
mirrors the reference op (``ppmx-edward.c:986-1003``); the rest are the
JAX package's extension ops, as int32 torch ops on any device (no Pallas
kernel computes them). ``contrast`` goes through a float64 LUT made on the
host, so it is exact for any factor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def grayscale(img: torch.Tensor) -> torch.Tensor:
    """uint8[H, W, 3] -> uint8[H, W]; exact integer (r+g+b)/3.

    The sum is taken in int32: uint8 ``r+g+b`` wraps in torch.
    """
    return (img.to(torch.int32).sum(-1) // 3).to(torch.uint8)


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


def contrast(img: torch.Tensor, factor: float) -> torch.Tensor:
    """clamp(round_half_up((v - 128) * factor + 128)) through the host LUT."""
    lut = torch.from_numpy(_contrast_lut(float(factor))).to(img.device)
    return lut[img.long()]


def threshold(img: torch.Tensor, thresh) -> torch.Tensor:
    """v >= thresh -> 255 else 0; exact."""
    return torch.where(img.to(torch.int32) >= thresh, 255, 0).to(torch.uint8)
