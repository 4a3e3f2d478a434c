"""The work of ``-w<new_width> -r<angle> -gray`` per image, stage by stage,
counted from the task's shapes and the reference's arithmetic (never from the
kernels that run):

- resize: as ``thumbnail_4k.py`` counts it, a multiply and an add in float64
  for every tap of every output value of each pass and a rounding per value;
- rotate: the inverse map's products once per output column (cos x0,
  -sin x0) and once per output row (sin y0, cos y0), its four adds and the
  two rounding adds of round(n) for every output pixel; for every interior
  pixel (``round(n)`` in [2, dim - 3] on both axes), per axis the offset
  n - floor(n) and the three other tap distances from it (4) and the four
  Keys weights (6 + 6 + 8 + 8 = 28), and per channel 16 products and 12
  adds for the rows and 4 products and 3 adds for the column (35); floors
  and compares are not counted, nor any work on an edge or black pixel
  beyond its map;
- gray: 2 integer adds and a divide for every output pixel.

Each stage reads its input once and writes its output once; the task reads
the frame once and writes the gray answer once.
"""

from __future__ import annotations

import functools

from port_bench.reference import resize, rotate

MAP_PRODUCTS = 2  # per output row and per output column
MAP_OPS_PER_PIXEL = 4 + 2
WEIGHT_OPS_PER_AXIS = 4 + 28
TAP_OPS_PER_CHANNEL = 4 * (4 + 3) + 4 + 3
GRAY_OPS_PER_PIXEL = 3


@functools.lru_cache(maxsize=8)
def interior_pixels(height: int, width: int, angle: float) -> int:
    """Output pixels of the rotation of a ``height`` x ``width`` image that
    are bicubic, from the reference's map and zones."""
    new_h = rotate.out_size(height, width, angle)[0]
    count = 0
    for y0 in range(0, new_h, rotate.ROWS):
        n_x, n_y = rotate.source_map(height, width, angle, y0, min(y0 + rotate.ROWS, new_h), "cpu")
        count += int(rotate.zones(n_x, n_y, height, width)[1].sum())
    return count


def _shapes(config: dict) -> tuple:
    """(resize f64 operations, (rows, cols) after the resize, after the rotation)."""
    h, w, c = config["height"], config["width"], config["channels"]
    shape, f64 = [h, w], 0
    for axis, indices, _ in resize.plan(h, w, config["new_width"]):
        shape[axis] = indices.shape[0]
        f64 += shape[0] * shape[1] * c * (2 * indices.shape[1] + 1)
    return f64, tuple(shape), rotate.out_size(*shape, config["angle"])


def per_stage(config: dict) -> dict:
    """{stage: {"bytes", "f64_ops", "int_ops"}} for one image, in the order applied."""
    h, w, c = config["height"], config["width"], config["channels"]
    resize_ops, (rh, rw), (oh, ow) = _shapes(config)
    interior = interior_pixels(rh, rw, float(config["angle"]))
    rot = (MAP_PRODUCTS * (oh + ow) + MAP_OPS_PER_PIXEL * oh * ow
           + interior * (2 * WEIGHT_OPS_PER_AXIS + TAP_OPS_PER_CHANNEL * c))
    return {
        "resize": {"bytes": h * w * c + rh * rw * c, "f64_ops": resize_ops, "int_ops": 0},
        "rotate": {"bytes": rh * rw * c + oh * ow * c, "f64_ops": rot, "int_ops": 0},
        "gray": {"bytes": oh * ow * c + oh * ow, "f64_ops": 0,
                 "int_ops": GRAY_OPS_PER_PIXEL * oh * ow},
    }


def per_image(config: dict) -> dict:
    stages = per_stage(config)
    oh, ow = _shapes(config)[2]
    return {"bytes": config["height"] * config["width"] * config["channels"] + oh * ow,
            "f64_ops": sum(s["f64_ops"] for s in stages.values()),
            "int_ops": sum(s["int_ops"] for s in stages.values())}
