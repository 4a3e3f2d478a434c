"""Small-stencil ops: box blur, sharpen, 5x5 Gaussian, Sobel.

Counterpart of ``imageprocessingtools_tpu/ops/stencil.py``. Integer-exact,
with replicate edges:

- box 3x3:      (2*sum9 + 9) // 18, i.e. floor(sum9 / 9 + 1/2);
- gaussian 5x5: separable binomial (1,4,6,4,1), (acc + 128) >> 8;
- sharpen 3x3:  [[0,-1,0],[-1,5,-1],[0,-1,0]], clipped to [0, 255];
- sobel:        clip(round_half_up(sqrt(gx^2 + gy^2))), exact through
  ``_isqrt_round`` (an f32 estimate and an integer fix-up).

Each op takes uint8[H, W] or uint8[H, W, C]. On a CUDA tensor it launches
K5 (Gaussian) or K7 (the 3x3 template) through ``kernels/core.py``, one
channel at a time; on a CPU tensor it runs the plain torch version there.
"""

from __future__ import annotations

import torch

# A module reference, not names: kernels.core imports ops.color, so either
# package may be imported first.
from imageprocessingtools_tpu_torch.kernels import core as _core


def _per_channel(wrapper, img: torch.Tensor) -> torch.Tensor:
    """Run a gray kernel wrapper on uint8[H, W] or on each channel of HWC."""
    if img.ndim == 3 and img.device.type != "cpu":
        return torch.stack(
            [wrapper(img[:, :, c].contiguous()) for c in range(img.shape[2])], dim=-1)
    return wrapper(img.contiguous())


def _isqrt_round(m: torch.Tensor) -> torch.Tensor:
    """round_half_up(sqrt(m)) for int32 m < 2^24, exact."""
    return _core._isqrt_round(m)


def box_blur(img: torch.Tensor) -> torch.Tensor:
    return _per_channel(_core.box_blur, img)


def sharpen(img: torch.Tensor) -> torch.Tensor:
    return _per_channel(_core.sharpen, img)


def gaussian_blur(img: torch.Tensor) -> torch.Tensor:
    """Separable binomial 5x5: two integer passes, one rounding shift."""
    return _per_channel(_core.gaussian_blur, img)


def sobel(img: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude round_half_up(sqrt(gx^2 + gy^2)), clamped."""
    return _per_channel(_core.sobel, img)
