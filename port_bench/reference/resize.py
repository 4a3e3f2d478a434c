"""The reference tool's ``-wN`` resize (``ppmx-edward.c:477-641, 820-868,
1084-1120``): Keys bicubic taps with antialiasing on downscale and mirrored
edges, in float64 on the host, applied pass by pass, each product and each
sum rounded on its own, in the tap order of the tables, then rounded half up
and clamped into uint8 between the passes. The smaller scale goes first.
"""

from __future__ import annotations

import math

import numpy as np
import torch

KERNEL_WIDTH = 4.0


def cubic(x: np.ndarray) -> np.ndarray:
    absx = np.abs(np.asarray(x, dtype=np.float64))
    absx2 = absx * absx
    absx3 = absx2 * absx
    ret = np.where(absx <= 1.0, (1.5 * absx3) - (2.5 * absx2) + 1.0, 0.0)
    return np.where((1.0 < absx) & (absx <= 2.0),
                    ret + ((-0.5 * absx3) + (2.5 * absx2) - (4.0 * absx) + 2.0), ret)


def contributions(in_size: int, out_size: int, scale: float) -> tuple[np.ndarray, np.ndarray]:
    """(indices int64[out, taps], weights float64[out, taps]) of one pass."""
    k_width = KERNEL_WIDTH / scale if scale < 1.0 else KERNEL_WIDTH
    taps = int(math.ceil(k_width)) + 2
    u = ((np.arange(out_size, dtype=np.float64) + 1.0) / scale) + (0.5 * (1.0 - (1.0 / scale)))
    left = np.floor(u - (k_width / 2.0))
    indices = (left[:, None] + (np.arange(taps, dtype=np.float64)[None, :] - 1.0)).astype(np.int64)
    dist = u[:, None] - indices.astype(np.float64) - 1.0
    weights = scale * cubic(dist * scale) if scale < 1.0 else cubic(dist)
    total = np.zeros(out_size, dtype=np.float64)
    for col in range(taps):  # the C's order of the row sums
        total += weights[:, col]
    weights = weights / total[:, None]
    mirror = np.concatenate([np.arange(in_size), np.arange(in_size - 1, -1, -1)])
    indices = mirror[np.mod(indices, 2 * in_size)]
    keep = weights[0, :] != 0.0  # taps pruned by output row 0's weights
    return indices[:, keep], weights[:, keep]


def plan(height: int, width: int, new_width: int) -> list[tuple[int, np.ndarray, np.ndarray]]:
    """[(axis, indices, weights)] of ``-w<new_width>`` in the order applied;
    axis 0 is the height, 1 the width. The new height truncates."""
    scale_w = float(new_width) / float(width)
    new_height = int(float(height) * scale_w)
    scale_h = float(new_height) / float(height)
    h = (0, *contributions(height, new_height, scale_h))
    w = (1, *contributions(width, new_width, scale_w))
    return [h, w] if scale_h < scale_w else [w, h]


def apply(images: torch.Tensor, axis: int, indices: np.ndarray, weights: np.ndarray,
          dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """One pass over uint8[N, H, W, C] along image ``axis``, summed in ``dtype``."""
    dim = axis + 1
    idx = torch.as_tensor(indices, device=images.device)
    w = torch.as_tensor(weights, device=images.device).to(dtype)
    shape = [1, 1, 1, 1]
    shape[dim] = idx.shape[0]
    acc = None
    for t in range(idx.shape[1]):
        term = images.index_select(dim, idx[:, t]).to(dtype) * w[:, t].reshape(shape)
        acc = term if acc is None else acc + term
    acc = torch.floor(acc + 0.5)
    acc = torch.where(acc < 0, torch.zeros_like(acc), acc)
    return torch.where(acc >= 256, torch.full_like(acc, 255), acc).to(torch.uint8)


def resize_width(images: torch.Tensor, new_width: int,
                 dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """``-w<new_width>`` of each image of uint8[N, H, W, C]."""
    out = images
    for axis, indices, weights in plan(images.shape[1], images.shape[2], new_width):
        out = apply(out, axis, indices, weights, dtype)
    return out
