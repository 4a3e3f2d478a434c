"""The thumbnail's algorithmic work per image: each input byte read once and
each output byte written once; a multiply and an add in float64 for every tap
of every output value of each pass, the taps as the reference's contribution
tables give them, and a rounding per output value."""

from port_bench.reference import resize


def per_image(config: dict) -> dict:
    h, w, c = config["height"], config["width"], config["channels"]
    shape, f64 = [h, w], 0
    for axis, indices, _ in resize.plan(h, w, config["new_width"]):
        shape[axis] = indices.shape[0]
        f64 += shape[0] * shape[1] * c * (2 * indices.shape[1] + 1)
    return {"bytes": h * w * c + shape[0] * shape[1] * c, "f64_ops": f64, "int_ops": 0}
