"""256-bin histogram, LUT application and histogram equalization.

Counterpart of ``imageprocessingtools_tpu/ops/histogram.py``. The JAX
package built both directions from nibble one-hot matmuls because the TPU
has no fast scatter or gather. Here ``histogram`` launches K4 on a CUDA
tensor (a bincount on a CPU tensor), and ``apply_lut`` is a torch gather.

``_equalize_lut`` keeps the JAX package's float32 arithmetic op for op
(multiply by 255.0, then divide), so the LUT is byte-identical to JAX's.
``equalize_histogram`` is K4, then that LUT, then K3 on a CUDA tensor.
"""

from __future__ import annotations

import math

import torch

# A module reference, not names: kernels.core imports ops.color, so either
# package may be imported first.
from imageprocessingtools_tpu_torch.kernels import core as _core
from imageprocessingtools_tpu_torch.ops.common import round_half_up


def histogram(img: torch.Tensor) -> torch.Tensor:
    """uint8[...] -> int32[256] bin counts (exact; < 2^31 total elements)."""
    return _core.histogram(img.contiguous())


def apply_lut(values: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """uint8 values through a 256-entry integer LUT (values in [0, 256))."""
    return _core.lut_apply_plain(values, lut)


def _equalize_lut(hist: torch.Tensor, n_pixels: int) -> torch.Tensor:
    """uint8[256] LUT from int32[256] counts."""
    cdf = torch.cumsum(hist, 0)
    cdf_min = torch.where(cdf > 0, cdf, torch.full_like(cdf, n_pixels)).min()
    denom = torch.clamp(n_pixels - cdf_min, min=1).to(torch.float32)
    lut = round_half_up((cdf - cdf_min).to(torch.float32) * 255.0 / denom)
    lut = torch.clamp(lut, 0, 255).to(torch.uint8)
    identity = torch.arange(256, dtype=torch.uint8, device=hist.device)
    return torch.where(cdf_min == n_pixels, identity, lut)


def equalize_histogram(img: torch.Tensor) -> torch.Tensor:
    """Classic CDF equalization of a gray uint8 image."""
    img = img.contiguous()
    lut = _equalize_lut(_core.histogram(img), math.prod(img.shape))
    return _core.lut_apply(img, lut)
