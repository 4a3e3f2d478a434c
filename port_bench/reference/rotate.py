"""The reference tool's ``-rN`` rotation (``rotate`` and ``calc_rot_size``,
``ppmx-edward.c:643-789``), clockwise, in plain torch.

- 0, 90, 180 and 270 degrees are the C's fast paths: the image as it is, or
  its pixels permuted.
- Any other angle: the bounding box of the angle folded into [0, 90], each
  side rounded half up; a black canvas; for each output pixel the inverse map
  about the integer centres ``dim // 2``, each product and sum rounded on its
  own in the C's order; the pixel is black unless ``round(n)`` lies in the
  source on both axes, bicubic (Keys, a = -0.5, 4 x 4 taps, rows summed then
  columns) where ``round(n)`` lies in [2, dim - 3] on both axes, clamped into
  [0, 255] and truncated, and the nearest source pixel on the band between.

The arithmetic runs in ``dtype`` (float64 as the C; the control passes
float32), ``rows`` output rows at a time.
"""

from __future__ import annotations

import math

import torch

ROWS = 256  # output rows computed together


def fold(angle: float) -> float:
    """The angle folded into [0, 90] for the bounding box (``:687-689``)."""
    if angle >= 270.0:
        return 360.0 - angle
    if angle > 180.0:
        return angle - 180.0
    if angle > 90.0:
        return 180.0 - angle
    return angle


def calc_rot_size(angle: float, width: int, height: int) -> tuple[int, int]:
    """(new width, new height) for an angle already folded (``:649-656``)."""
    theta = (angle * math.pi) / 180.0
    new_w = math.floor((width * math.cos(theta)) + (height * math.sin(theta)) + 0.5)
    new_h = math.floor((width * math.sin(theta)) + (height * math.cos(theta)) + 0.5)
    return int(new_w), int(new_h)


def out_size(height: int, width: int, angle: float) -> tuple[int, int]:
    """(new height, new width) of the rotation of a ``height`` x ``width`` image."""
    angle = float(angle)
    if angle in (0.0, 180.0):
        return height, width
    if angle in (90.0, 270.0):
        return width, height
    new_w, new_h = calc_rot_size(fold(angle), width, height)
    return new_h, new_w


def _keys(x: torch.Tensor) -> torch.Tensor:
    """The C's ``cubic`` (``:477-489``), op by op in its order."""
    a = x.abs()
    a2 = a * a
    a3 = a2 * a
    near = ((1.5 * a3) - (2.5 * a2)) + 1.0
    far = (((-0.5 * a3) + (2.5 * a2)) - (4.0 * a)) + 2.0
    zero = torch.zeros_like(x)
    return torch.where(a <= 1.0, near, torch.where((a > 1.0) & (a <= 2.0), far, zero))


def source_map(height: int, width: int, angle: float, y0: int, y1: int, device,
               dtype: torch.dtype = torch.float64) -> tuple[torch.Tensor, torch.Tensor]:
    """(nX, nY), ``dtype``[y1 - y0, new width]: the source position of each
    output pixel of rows [y0, y1) (``:729-743``)."""
    new_h, new_w = out_size(height, width, angle)
    theta = (float(angle) * math.pi) / 180.0
    cos_t, sin_t = math.cos(theta), math.sin(theta)
    xc, yc = width // 2, height // 2
    x_off, y_off = new_w // 2 - xc, new_h // 2 - yc
    x0 = (torch.arange(new_w, device=device, dtype=dtype) - x_off) - xc
    y0_ = (torch.arange(y0, y1, device=device, dtype=dtype) - y_off) - yc
    n_x = ((cos_t * x0)[None, :] + (sin_t * y0_)[:, None]) + xc
    n_y = ((-sin_t * x0)[None, :] + (cos_t * y0_)[:, None]) + yc
    return n_x, n_y


def zones(n_x: torch.Tensor, n_y: torch.Tensor, height: int, width: int):
    """(inside, interior), bool: ``round(n)`` in the source, and in
    [2, dim - 3] on both axes (``:744-752``)."""
    r_x, r_y = torch.floor(n_x + 0.5), torch.floor(n_y + 0.5)
    inside = (r_x >= 0) & (r_y >= 0) & (r_x < width) & (r_y < height)
    interior = inside & (r_x > 1) & (r_y > 1) & (r_x < width - 2) & (r_y < height - 2)
    return inside, interior


def _rows(images: torch.Tensor, angle: float, y0: int, y1: int, dtype) -> torch.Tensor:
    """Output rows [y0, y1) of uint8[N, H, W, C] rotated by an arbitrary angle."""
    n, h, w, c = images.shape
    n_x, n_y = source_map(h, w, angle, y0, y1, images.device, dtype)
    inside, interior = zones(n_x, n_y, h, w)
    flat = images.reshape(n, h * w, c)
    near = (torch.floor(n_y + 0.5).clamp(0, h - 1).long() * w
            + torch.floor(n_x + 0.5).clamp(0, w - 1).long())
    nearest = flat[:, near.reshape(-1)].reshape(n, y1 - y0, -1, c)
    base_y, base_x = torch.floor(n_y) - 1.0, torch.floor(n_x) - 1.0
    src = flat.to(dtype)
    acc = None
    for j in range(4):
        v = base_y + j
        w_y = _keys(n_y - v)[None, :, :, None]
        row = v.clamp(0, h - 1).long() * w
        p = None
        for i in range(4):
            u = base_x + i
            w_x = _keys(n_x - u)[None, :, :, None]
            tap = src[:, (row + u.clamp(0, w - 1).long()).reshape(-1)].reshape(n, y1 - y0, -1, c)
            p = tap * w_x if p is None else p + tap * w_x
        acc = p * w_y if acc is None else acc + p * w_y
    acc = torch.where(acc < 0.0, torch.zeros_like(acc), acc)
    acc = torch.where(acc >= 256.0, torch.full_like(acc, 255.0), acc)
    bicubic = acc.to(torch.int64).to(torch.uint8)  # the C's (int) cast truncates
    out = torch.zeros_like(nearest)
    out = torch.where(inside[None, :, :, None], nearest, out)
    return torch.where(interior[None, :, :, None], bicubic, out)


def rotate(images: torch.Tensor, angle: float, dtype: torch.dtype = torch.float64,
           rows: int = ROWS) -> torch.Tensor:
    """``-r<angle>`` of each image of uint8[N, H, W, C] (C 1 or 3)."""
    angle = float(angle)
    if angle == 0.0:
        return images.clone()
    if angle == 90.0:  # out[x][H-1-y] = in[y][x] (:714-717)
        return torch.flip(images.transpose(1, 2), dims=(2,)).contiguous()
    if angle == 180.0:
        return torch.flip(images, dims=(1, 2))
    if angle == 270.0:  # out[W-1-x][y] = in[y][x] (:722-725)
        return torch.flip(images.transpose(1, 2), dims=(1,)).contiguous()
    new_h = out_size(images.shape[1], images.shape[2], angle)[0]
    return torch.cat([_rows(images, angle, y0, min(y0 + rows, new_h), dtype)
                      for y0 in range(0, new_h, rows)], dim=1)
