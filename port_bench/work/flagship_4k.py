"""The flagship's algorithmic work per image of H x W x 3: each input byte read
once and each output byte written once; integer operations per pixel: the
gray's 2 adds and 1 divide, the Gaussian's 5 multiplies and 4 adds per axis
and its rounding add and shift, the histogram's increment and the LUT's
gather (the 256-entry LUT itself is negligible)."""

INT_OPS_PER_PIXEL = 3 + 2 * (5 + 4) + 2 + 1 + 1


def per_image(config: dict) -> dict:
    pixels = config["height"] * config["width"]
    return {"bytes": pixels * 3 + pixels, "f64_ops": 0, "int_ops": pixels * INT_OPS_PER_PIXEL}
