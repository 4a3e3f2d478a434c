"""print_ready's work per image, stage by stage, counted from the task's
shapes and the reference tool's arithmetic (never from the kernels that run):

- gray: reads the frame, writes the gray; 2 integer adds and a divide a
  pixel;
- equalize: the histogram reads the gray, the LUT's application reads it
  again and writes the equalized gray; an increment and a gather a pixel
  (the 256-entry LUT itself is negligible);
- dither: reads the equalized gray; a pixel's average of its three equal
  channels (2 adds and a divide), its threshold's index (x % 4) * 4 + y % 4
  (2 remainders, a multiply and an add), in float64 the C's m * 255.0 and
  its compare; its bits go straight to the packing;
- pack: writes the rows, each padded to a byte; a shift and an or a pixel.

The dither's bits are not counted as written and read again: a pass that
dithers and packs reads the gray once and writes the rows once, and the two
stages' least time is that pass's. The task reads the frame once and writes
the packed rows once.
"""

from __future__ import annotations

GRAY_OPS = 3
EQUALIZE_OPS = 2
DITHER_INT_OPS = 3 + 4
DITHER_F64_OPS = 2
PACK_OPS = 2


def _sizes(config: dict) -> tuple:
    """(pixels, channels, packed bytes) of one image."""
    h, w = config["height"], config["width"]
    return h * w, config["channels"], h * ((w + 7) // 8)


def per_stage(config: dict) -> dict:
    """{stage: {"bytes", "f64_ops", "int_ops"}} for one image, in the order applied."""
    p, c, packed = _sizes(config)
    return {
        "gray": {"bytes": p * c + p, "f64_ops": 0, "int_ops": GRAY_OPS * p},
        "equalize": {"bytes": 3 * p, "f64_ops": 0, "int_ops": EQUALIZE_OPS * p},
        "dither": {"bytes": p, "f64_ops": DITHER_F64_OPS * p, "int_ops": DITHER_INT_OPS * p},
        "pack": {"bytes": packed, "f64_ops": 0, "int_ops": PACK_OPS * p},
    }


def per_image(config: dict) -> dict:
    p, c, packed = _sizes(config)
    stages = per_stage(config)
    return {"bytes": p * c + packed,
            "f64_ops": sum(s["f64_ops"] for s in stages.values()),
            "int_ops": sum(s["int_ops"] for s in stages.values())}
