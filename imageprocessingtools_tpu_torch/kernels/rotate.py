"""K1: arbitrary-angle rotation — the CUDA kernel's wrapper and its plain version.

Counterpart of ``imageprocessingtools_tpu/kernels/pallas_rotate.py::
rotate_blocked_pallas``; the kernel is ``csrc/rotate.cu``. Both versions here
compute the reference's f64 arithmetic (``ops/_exact.py::plan_rotation``,
``golden/model.py::rotate``) in the same order, so both are byte-identical
to the C. ``rotate_bicubic`` takes the plain version for a CPU tensor and
launches the kernel for a CUDA tensor, with the kernel's per-tile plan
(``tile_plan``) made on the host once per geometry.
"""

from __future__ import annotations

import functools
import math

import torch

from imageprocessingtools_tpu_torch.kernels import _build
from imageprocessingtools_tpu_torch.ops import _exact

TILE = 32  # the kernel's output tile side (csrc/rotate.cu)
_MAX_GRID_Y = 65535 * TILE  # output rows per launch: grid.y tiles of TILE rows
# Tile classes of ``tile_plan`` (csrc/rotate.cu reads the same numbers).
OUTSIDE, INTERIOR, MIXED = 0, 1, 2


def _geometry(height: int, width: int, angle: float):
    """Bounding box, cos/sin and integer centres (``_exact.py:249-256``)."""
    new_w, new_h = _exact.calc_rot_size(_exact.fold_angle(angle), width, height)
    theta = (angle * math.pi) / 180.0
    x_center, y_center = width // 2, height // 2
    return (new_h, new_w, math.cos(theta), math.sin(theta), x_center, y_center,
            new_w // 2 - x_center, new_h // 2 - y_center)


def _inverse_map(geometry, ox: torch.Tensor, oy: torch.Tensor):
    """(nX, nY), f64 [len(oy), len(ox)]: the source position of each output
    pixel (oy, ox), rounded op by op as the C does."""
    _, _, cos_t, sin_t, xc, yc, xoff, yoff = geometry
    xs = (ox.to(torch.float64) - xoff) - xc
    ys = (oy.to(torch.float64) - yoff) - yc
    n_x = ((cos_t * xs)[None, :] + (sin_t * ys)[:, None]) + xc
    n_y = ((-sin_t * xs)[None, :] + (cos_t * ys)[:, None]) + yc
    return n_x, n_y


def tile_plan(height: int, width: int, angle: float):
    """The kernel's plan: (int32[tiles, 4], box_w, box_h).

    Row ``by * tiles_x + bx`` describes output tile (by, bx) of TILE x TILE
    pixels as {class, lo_x, lo_y, bw | bh << 16}. Since the inverse map is
    affine, every pixel's (nX, nY) lies between the tile's four corners'
    (up to rounding, which a margin of one pixel covers), so:

    - OUTSIDE: one bound of the source is missed by all four corners (every
      pixel is 0);
    - INTERIOR: all four corners round into the interior band (every pixel
      is bicubic; the kernel skips the zone tests);
    - MIXED: the rest. Each pixel is tested.

    The footprint [lo_y, lo_y + bh) x [lo_x, lo_x + bw) holds floor(n) - 2 ..
    floor(n) + 3 of the corners' extremes, clamped to the source: every tap
    (floor(n) - 1 .. floor(n) + 2) of an interior pixel and every nearest
    pixel of an edge pixel. box_w and box_h are the largest footprint;
    OUTSIDE tiles have none.
    """
    geometry = _geometry(height, width, angle)
    new_h, new_w = geometry[0], geometry[1]
    tiles_y, tiles_x = -(-new_h // TILE), -(-new_w // TILE)

    def corners(n_tiles, size):
        first = torch.arange(n_tiles, dtype=torch.int64) * TILE
        return torch.stack([first, (first + TILE - 1).clamp(max=size - 1)], -1).reshape(-1)

    n_x, n_y = _inverse_map(geometry, corners(tiles_x, new_w), corners(tiles_y, new_h))

    def span(n):  # min and max over each tile's four corners, [tiles_y, tiles_x]
        n = n.reshape(tiles_y, 2, tiles_x, 2)
        return n.amin((1, 3)), n.amax((1, 3))

    (min_x, max_x), (min_y, max_y) = span(n_x), span(n_y)
    # A pixel is in bounds iff -0.5 <= n < dim - 0.5 on both axes, interior
    # iff 1.5 <= n < dim - 2.5; the tests below carry a margin of 1.
    outside = ((max_x < -1.5) | (min_x >= width + 0.5)
               | (max_y < -1.5) | (min_y >= height + 0.5))
    interior = ((min_x >= 2.5) & (max_x < width - 3.5)
                & (min_y >= 2.5) & (max_y < height - 3.5))
    cls = torch.where(outside, OUTSIDE, torch.where(interior, INTERIOR, MIXED))

    def box(lo, hi, size):
        lo = (torch.floor(lo) - 2).clamp(0, size - 1).to(torch.int64)
        hi = (torch.floor(hi) + 3).clamp(0, size - 1).to(torch.int64)
        return lo, torch.where(outside, 0, hi - lo + 1)

    (lo_x, bw), (lo_y, bh) = box(min_x, max_x, width), box(min_y, max_y, height)
    plan = torch.stack([cls, lo_x, lo_y, bw | (bh << 16)], -1).reshape(-1, 4)
    box_w, box_h = int(bw.max()), int(bh.max())
    return plan.to(torch.int32), box_w, box_h


@functools.lru_cache(maxsize=32)
def _host_plan(height: int, width: int, angle: float):
    return tile_plan(height, width, angle)


@functools.lru_cache(maxsize=32)
def _device_plan(height: int, width: int, angle: float, device: torch.device):
    plan, box_w, box_h = _host_plan(height, width, angle)
    return plan.to(device), box_w, box_h


@functools.lru_cache(maxsize=256)
def band_window(height: int, width: int, angle: float, oy0: int, oy1: int):
    """The source rows [lo, hi) that output rows [oy0, oy1) read, or None
    when every pixel there is 0. ``oy0`` is a multiple of TILE; the window
    is the union of the footprints of the band's tiles that are not
    OUTSIDE (their ``bh`` is 0 and sets nothing)."""
    if oy0 % TILE or not 0 <= oy0 < oy1:
        raise ValueError(f"band_window: rows [{oy0}, {oy1}) do not start on a tile row")
    plan, _, _ = _host_plan(height, width, angle)
    tiles_x = -(-_geometry(height, width, angle)[1] // TILE)
    rows = plan[oy0 // TILE * tiles_x : -(-oy1 // TILE) * tiles_x]
    rows = rows[rows[:, 0] != OUTSIDE]
    if not len(rows):
        return None
    lo_y = rows[:, 2].to(torch.int64)
    return int(lo_y.min()), int((lo_y + (rows[:, 3].to(torch.int64) >> 16)).max())


def _band(img: torch.Tensor, angle: float, height, src_row0: int, out_rows):
    """(global height, src_row0, oy0, oy1) of a band call, checked: the
    source window must hold the rows that the band reads (``band_window``)."""
    height = img.shape[0] if height is None else int(height)
    new_h = _geometry(height, img.shape[1], angle)[0]
    oy0, oy1 = (0, new_h) if out_rows is None else map(int, out_rows)
    if not (0 <= src_row0 and src_row0 + img.shape[0] <= height and 0 <= oy0 <= oy1 <= new_h
            and oy0 % TILE == 0):
        raise ValueError(
            f"rotate: a window of rows [{src_row0}, {src_row0 + img.shape[0]}) of {height} "
            f"and output rows [{oy0}, {oy1}) of {new_h} (a multiple of {TILE} first)")
    window = band_window(height, img.shape[1], angle, oy0, oy1) if oy1 > oy0 else None
    if window is not None and not (src_row0 <= window[0] and window[1] <= src_row0 + img.shape[0]):
        raise ValueError(
            f"rotate: output rows [{oy0}, {oy1}) read source rows [{window[0]}, {window[1]}), "
            f"outside the window [{src_row0}, {src_row0 + img.shape[0]})")
    return height, src_row0, oy0, oy1


def _cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys a=-0.5 kernel in the order of ``_exact.cubic``, one op at a time."""
    absx = x.abs()
    absx2 = absx * absx
    absx3 = absx2 * absx
    inner = ((1.5 * absx3) - (2.5 * absx2)) + 1.0
    outer = (((-0.5 * absx3) + (2.5 * absx2)) - (4.0 * absx)) + 2.0
    zero = torch.zeros_like(x)
    ret = torch.where(absx <= 1.0, inner, zero)
    return torch.where((absx > 1.0) & (absx <= 2.0), outer, ret)


def rotate_plain(img: torch.Tensor, angle_deg: float, height: int | None = None,
                 src_row0: int = 0, out_rows=None) -> torch.Tensor:
    """Plain torch form of K1, on the input's device: f64 with separate ops
    (no fused multiply-add), byte-identical to ``golden.rotate``.

    uint8[H, W, C] or uint8[H, W] -> uint8[newH, newW(, C)]. The band form,
    as K1's: ``img`` holds rows [src_row0, src_row0 + rows) of an image of
    ``height`` rows, and the result is output rows ``out_rows`` = (oy0, oy1)
    of its rotation (oy0 a multiple of TILE); the window must hold what
    they read.
    """
    angle = float(angle_deg)
    h, src_row0, oy0, oy1 = _band(img, angle, height, int(src_row0), out_rows)
    squeeze = img.ndim == 2
    src = img[:, :, None] if squeeze else img
    rows, w, c = src.shape
    geometry = _geometry(h, w, angle)
    new_w = geometry[1]
    f64, dev = torch.float64, img.device
    nX, nY = _inverse_map(geometry, torch.arange(new_w, device=dev),
                          torch.arange(oy0, oy1, device=dev))
    rX = torch.floor(nX + 0.5)
    rY = torch.floor(nY + 0.5)
    in_bounds = (rX < w) & (rY < h) & (rY >= 0) & (rX >= 0)
    interior = (in_bounds & (rX > 1) & (rY > 1)
                & (rX < max(w - 2, 0)) & (rY < max(h - 2, 0)))
    edge = in_bounds & ~interior

    # Source rows are global; the window starts at src_row0. Discarded
    # pixels may reach outside it, so every row index clamps into it.
    flat = src.reshape(rows * w, c)
    near_y = rY.clamp(0, h - 1).long() - src_row0
    nearest = flat[near_y.clamp(0, max(rows - 1, 0)) * w + rX.clamp(0, w - 1).long()]

    by = torch.floor(nY) - 1.0
    bx = torch.floor(nX) - 1.0
    # Tap rows/cols clamp into range; only non-interior pixels (discarded
    # below) ever need the clamp.
    iy = by.clamp(0, max(h - 4, 0)).long()
    ix = bx.clamp(0, max(w - 4, 0)).long()
    src64 = flat.to(f64)
    acc = torch.zeros((oy1 - oy0, new_w, c), dtype=f64, device=dev)
    for j in range(4):
        wy = _cubic(nY - (by + j))[:, :, None]
        ty = ((iy + j).clamp(0, h - 1) - src_row0).clamp(0, max(rows - 1, 0)) * w
        p = torch.zeros_like(acc)
        for i in range(4):
            wx = _cubic(nX - (bx + i))[:, :, None]
            p = p + src64[ty + (ix + i).clamp(0, w - 1)] * wx
        acc = acc + p * wy
    acc = torch.where(acc < 0.0, torch.zeros_like(acc), acc)
    acc = torch.where(acc >= 256.0, torch.full_like(acc, 255.0), acc)
    interior_val = acc.to(torch.int64).to(torch.uint8)  # (int) cast truncates

    out = torch.zeros((oy1 - oy0, new_w, c), dtype=torch.uint8, device=dev)
    out = torch.where(edge[:, :, None], nearest, out)
    out = torch.where(interior[:, :, None], interior_val, out)
    return out[:, :, 0] if squeeze else out


def rotate_bicubic(img: torch.Tensor, angle_deg: float, height: int | None = None,
                   src_row0: int = 0, out_rows=None) -> torch.Tensor:
    """Rotate clockwise by ``angle_deg``: K1 on a CUDA tensor, the plain
    version on a CPU tensor. uint8[H, W, C] or uint8[H, W], contiguous.
    ``height``, ``src_row0`` and ``out_rows`` give the band form (see
    ``rotate_plain``); by default the whole image."""
    if img.device.type == "cpu":
        return rotate_plain(img, angle_deg, height, src_row0, out_rows)
    if img.device.type != "cuda":
        raise TypeError(f"rotate_bicubic: unsupported device {img.device}")
    if img.dtype != torch.uint8 or img.ndim not in (2, 3) or not img.is_contiguous():
        raise TypeError(
            f"rotate_bicubic: need a contiguous uint8[H, W(, C)] tensor, got "
            f"{img.dtype} {tuple(img.shape)} contiguous={img.is_contiguous()}")
    angle = float(angle_deg)
    h, src_row0, oy0, oy1 = _band(img, angle, height, int(src_row0), out_rows)
    squeeze = img.ndim == 2
    w = img.shape[1]
    c = 1 if squeeze else img.shape[2]
    if c not in (1, 3):
        raise TypeError(f"rotate_bicubic: the kernel takes 1 or 3 channels, got {c}")
    new_h, new_w, cos_t, sin_t, xc, yc, xoff, yoff = _geometry(h, w, angle)
    if oy1 - oy0 > _MAX_GRID_Y or max(h * w * c, new_h * new_w * c) >= 2**31:
        raise RuntimeError(f"rotate_bicubic: {h}x{w}x{c} -> {new_h}x{new_w} is too large")
    out = torch.empty((oy1 - oy0, new_w, c), dtype=torch.uint8, device=img.device)
    if out.numel():
        plan, box_w, box_h = _device_plan(h, w, angle, img.device)
        first_tile = plan[oy0 // TILE * -(-new_w // TILE):]
        status = _build.library().ipt_rotate(
            img.data_ptr(), src_row0, img.shape[0], out.data_ptr(), h, w, c, oy1 - oy0, new_w,
            cos_t, sin_t, xc, yc, xoff, yoff - oy0, first_tile.data_ptr(), box_w, box_h,
            img.device.index, torch.cuda.current_stream(img.device).cuda_stream)
        _build.check(status, "ipt_rotate")
        rotate_bicubic.launches += 1
    return out[:, :, 0] if squeeze else out


rotate_bicubic.launches = 0
