"""The flagship's reference: gray as (r + g + b) // 3, a 5x5 Gaussian with
taps (1, 4, 6, 4, 1) per axis over edge-replicated gray, rounded as
(sum + 128) >> 8, all in integers; then the blur's 256-bin histogram and its
equalization LUT in float32, as the configuration states:
floor((cdf - cdf_min) * 255 / max(n - cdf_min, 1) + 0.5), clamped into
[0, 255], the identity where one bin holds every pixel. Its control computes
the LUT in bfloat16."""

from __future__ import annotations

import torch

TAPS = (1, 4, 6, 4, 1)


def _blur(images: torch.Tensor) -> torch.Tensor:
    """uint8[N, H, W, 3] -> the Gaussian of the gray, uint8[N, H, W]."""
    gray = images.to(torch.int32).sum(-1) // 3
    n, h, w = gray.shape
    r = len(TAPS) // 2
    ys = torch.arange(-r, h + r, device=gray.device).clamp(0, h - 1)
    xs = torch.arange(-r, w + r, device=gray.device).clamp(0, w - 1)
    padded = gray[:, ys][:, :, xs]
    rows = sum(k * padded[:, dy:dy + h] for dy, k in enumerate(TAPS))
    acc = sum(k * rows[:, :, dx:dx + w] for dx, k in enumerate(TAPS))
    return ((acc + 128) >> 8).to(torch.uint8)


def _equalized(blur: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    n_pixels = blur.shape[1] * blur.shape[2]
    outs = []
    for img in blur:
        cdf = torch.bincount(img.reshape(-1).to(torch.int64), minlength=256).cumsum(0)
        cdf_min = torch.where(cdf > 0, cdf, torch.full_like(cdf, n_pixels)).min()
        denom = torch.clamp(n_pixels - cdf_min, min=1).to(dtype)
        lut = torch.floor((cdf - cdf_min).to(dtype) * 255.0 / denom + 0.5)
        lut = torch.clamp(lut, 0, 255).to(torch.uint8)
        if int(cdf_min) == n_pixels:
            lut = torch.arange(256, dtype=torch.uint8, device=blur.device)
        outs.append(lut[img.to(torch.int64)])
    return torch.stack(outs)


def expected(images: torch.Tensor, config: dict) -> torch.Tensor:
    return _equalized(_blur(images), torch.float32)


def control(images: torch.Tensor, config: dict) -> torch.Tensor:
    return _equalized(_blur(images), torch.bfloat16)
