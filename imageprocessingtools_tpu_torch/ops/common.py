"""Shared tensor helpers: exact rounding and uint8 quantization.

Counterpart of ``imageprocessingtools_tpu/ops/common.py``. The reference
rounds with ``floor(v + 0.5)`` (round-half-up, ``ppmx-edward.c:27``) and
clamps with ``< 0 -> 0``, ``>= 256 -> 255`` (``ppmx-edward.c:831-837``).
``torch.round`` rounds half to even and must never be used on a parity path.

The JAX package's ``float_stage_budget`` has no counterpart here: the port
has no inexact stage (rotation and resize are f64 in the C's order), so every
chain is held byte-equal to the golden model.
"""

from __future__ import annotations

import torch


def round_half_up(x: torch.Tensor) -> torch.Tensor:
    """floor(x + 0.5) — the reference's rounding everywhere."""
    return torch.floor(x + 0.5)


def clamp_u8(x: torch.Tensor) -> torch.Tensor:
    """Reference clamp: < 0 -> 0, >= 256 -> 255 (float or int x)."""
    x = torch.where(x < 0, torch.zeros_like(x), x)
    x = torch.where(x >= 256, torch.full_like(x, 255), x)
    return x.to(torch.uint8)


def quantize_u8(acc: torch.Tensor) -> torch.Tensor:
    """round-half-up + reference clamp + uint8 cast (resize epilogue)."""
    return clamp_u8(round_half_up(acc))

