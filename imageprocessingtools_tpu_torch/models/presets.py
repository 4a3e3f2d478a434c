"""Named pipeline presets built from the op library.

Counterpart of ``imageprocessingtools_tpu/models/presets.py``, with the
same compositions. On a CUDA tensor the stages run through the port's
kernels: ``edge_detect`` through K6 (gray fused into the Gaussian, as XLA
fuses the two stages for the JAX package) and K7 (Sobel), ``enhance``
through K8 (gray), K4, K3 and K7 (sharpen), ``print_ready`` through K8, K4
and K3, ``thumbnail`` through K9 (one launch per axis; exact, like the rest).
"""

from __future__ import annotations

import functools

import torch

from imageprocessingtools_tpu_torch import ops
from imageprocessingtools_tpu_torch.codec.ppm import FILETYPE_PBM, FILETYPE_PGM, FILETYPE_PPM
from imageprocessingtools_tpu_torch.kernels import core
from imageprocessingtools_tpu_torch.ops import _exact
from imageprocessingtools_tpu_torch.pipeline import PipelineConfig, run_pipeline

THUMBNAIL_WIDTH = 256


def reference_pipeline(config: PipelineConfig):
    """The reference's fixed-order pipeline as a callable on one image."""

    def fn(img: torch.Tensor) -> torch.Tensor:
        out, _ = run_pipeline(img, config)
        return out

    return fn


def edge_detect(img: torch.Tensor) -> torch.Tensor:
    """gray -> 5x5 Gaussian (denoise) -> Sobel magnitude."""
    return ops.sobel(core.gray_gauss(img.contiguous()))


def enhance(img: torch.Tensor) -> torch.Tensor:
    """gray -> histogram equalization -> sharpen."""
    return ops.sharpen(ops.equalize_histogram(ops.grayscale(img)))


def thumbnail(img: torch.Tensor, width: int = 256) -> torch.Tensor:
    """Antialiased bicubic downscale to a target width (MATLAB-compatible)."""
    return ops.resize_width(img, width)


def print_ready(img: torch.Tensor) -> torch.Tensor:
    """gray -> contrast stretch -> Bayer bilevel (P4-ready bits)."""
    eq = ops.equalize_histogram(ops.grayscale(img))
    return ops.mono_dither(eq[..., None].expand(eq.shape + (3,)))


PRESETS = {
    "edge_detect": edge_detect,
    "enhance": enhance,
    "thumbnail": functools.partial(thumbnail, width=THUMBNAIL_WIDTH),
    "print_ready": print_ready,
}

# Output encoding per preset (serving writes one file per input):
# 0 = P6 colour, 1 = P5 gray, 2 = P4 bilevel (values {0, 1}, device-packed).
PRESET_FILE_TYPES = {
    "edge_detect": FILETYPE_PGM,
    "enhance": FILETYPE_PGM,
    "thumbnail": FILETYPE_PPM,
    "print_ready": FILETYPE_PBM,
}


def _gray_shape(h: int, w: int) -> tuple:
    return (h, w)


def _thumbnail_shape(h: int, w: int) -> tuple:
    plan = _exact.plan_resize(h, w, THUMBNAIL_WIDTH)  # raises B7/B9 like the resize
    return (plan.new_height, plan.new_width, 3)


# Output shape per preset for one (h, w, 3) input, before P4 packing. The
# JAX package traces the preset for it (``jax.eval_shape``); serving needs
# it before any file is decoded, so each preset states it here.
PRESET_OUTPUT_SHAPES = {
    "edge_detect": _gray_shape,
    "enhance": _gray_shape,
    "thumbnail": _thumbnail_shape,
    "print_ready": _gray_shape,
}


def get_preset(name: str):
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        ) from None


def preset_output_shape(name: str, h: int, w: int) -> tuple:
    """Unpacked output shape of preset ``name`` for one (h, w, 3) input."""
    get_preset(name)  # raises ValueError for unknown names
    return PRESET_OUTPUT_SHAPES[name](h, w)
