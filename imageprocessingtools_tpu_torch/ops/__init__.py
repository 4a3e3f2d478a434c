"""Tensor ops of the port (counterpart of ``imageprocessingtools_tpu/ops``).

Reference-parity ops, all bit-exact (rotation and resize are f64 in the C's
order): grayscale, mono_dither, flip_vertical, flip_horizontal, rotate (any
angle), resize_width (and resize_width_exact, its name in the JAX package).

Extension of resize, bit-exact with the same taps: resize (explicit H and W).

Batch forms (each image of uint8[N, ...] as the op gives it, ``jax.vmap``'s
one op over the batch): resize_width_batch, resize_batch, rotate_batch,
flip_vertical_batch, flip_horizontal_batch; grayscale, mono_dither and
pack_bits_device take leading axes as they are.

Extension ops, all bit-exact: invert, brightness, contrast, threshold,
box_blur, sharpen, gaussian_blur, sobel, histogram, equalize_histogram,
apply_lut, pack_bits_device.
"""

from imageprocessingtools_tpu_torch.ops.color import (  # noqa: F401
    brightness,
    contrast,
    grayscale,
    invert,
    threshold,
)
from imageprocessingtools_tpu_torch.ops.dither import mono_dither  # noqa: F401
from imageprocessingtools_tpu_torch.ops.geometry import (  # noqa: F401
    flip_horizontal,
    flip_horizontal_batch,
    flip_vertical,
    flip_vertical_batch,
    rotate,
    rotate_batch,
    rotate90,
    rotate180,
    rotate270,
    rotate_exact,
)
from imageprocessingtools_tpu_torch.ops.histogram import (  # noqa: F401
    apply_lut,
    equalize_histogram,
    histogram,
)
from imageprocessingtools_tpu_torch.ops.packing import pack_bits_device  # noqa: F401
from imageprocessingtools_tpu_torch.ops.resize import (  # noqa: F401
    resize,
    resize_batch,
    resize_width,
    resize_width_batch,
    resize_width_exact,
)
from imageprocessingtools_tpu_torch.ops.stencil import (  # noqa: F401
    box_blur,
    gaussian_blur,
    sharpen,
    sobel,
)
