"""Named pipeline presets built from the op library.

Counterpart of ``imageprocessingtools_tpu/models/presets.py``, with the
same compositions. On a CUDA tensor the stages run through the port's
kernels: ``edge_detect`` through K6 (gray fused into the Gaussian, as XLA
fuses the two stages for the JAX package) and K7 (Sobel), ``enhance``
through K8 (gray), K4, K3 and K7 (sharpen), ``print_ready`` through K8, K4
and K3, ``thumbnail`` through K9 (one launch per axis; exact, like the rest).

Every preset, and every ``reference_pipeline`` callable, carries a batch
form (``utils/graphs.py::batch_form``), the counterpart of ``jax.vmap`` of
the preset: uint8[N, H, W, 3] -> uint8[N, ...], each image as the preset
gives it, each kernel launched once over the batch (K6 and K7 Sobel; K8,
K4, K3 and K7 sharpen; K8, K4 and K3, then the dither; K9 twice for
``thumbnail``; ``pipeline.run_pipeline_batch`` for a reference config).
``print_ready_p4`` is print_ready with its P4 packing, the dither and the
packing in one launch of K10 (``PRESET_P4_FORMS``: serving's form of it).
"""

from __future__ import annotations

import functools

import torch

from imageprocessingtools_tpu_torch import ops
from imageprocessingtools_tpu_torch.codec.ppm import FILETYPE_PBM, FILETYPE_PGM, FILETYPE_PPM
from imageprocessingtools_tpu_torch.kernels import core
from imageprocessingtools_tpu_torch.ops import _exact
from imageprocessingtools_tpu_torch.ops.histogram import equalize_histogram_batch
from imageprocessingtools_tpu_torch.pipeline import PipelineConfig, run_pipeline, run_pipeline_batch
from imageprocessingtools_tpu_torch.utils.graphs import batch_form

THUMBNAIL_WIDTH = 256


def reference_pipeline(config: PipelineConfig):
    """The reference's fixed-order pipeline as a callable on one image, with
    its batch form (``run_pipeline_batch``)."""

    def fn(img: torch.Tensor) -> torch.Tensor:
        out, _ = run_pipeline(img, config)
        return out

    @batch_form(fn)
    def fn_batch(imgs: torch.Tensor) -> torch.Tensor:
        out, _ = run_pipeline_batch(imgs, config)
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


@batch_form(edge_detect)
def edge_detect_batch(imgs: torch.Tensor) -> torch.Tensor:
    """``edge_detect`` of each image of uint8[N, H, W, 3]."""
    return core.sobel_batch(core.gray_gauss_batch(imgs.contiguous()))


@batch_form(enhance)
def enhance_batch(imgs: torch.Tensor) -> torch.Tensor:
    """``enhance`` of each image of uint8[N, H, W, 3]."""
    return core.sharpen_batch(equalize_histogram_batch(ops.grayscale(imgs)))


@batch_form(print_ready)
def print_ready_batch(imgs: torch.Tensor) -> torch.Tensor:
    """``print_ready`` of each image of uint8[N, H, W, 3]."""
    eq = equalize_histogram_batch(ops.grayscale(imgs))
    return ops.mono_dither(eq[..., None].expand(eq.shape + (3,)))


def print_ready_p4(img: torch.Tensor) -> torch.Tensor:
    """``print_ready``'s P4 rows of one image, uint8[H, ceil(W / 8)], as
    ``pack_bits_device(print_ready(img))`` gives them: the dither and the
    packing in one pass (K10 on a CUDA tensor)."""
    eq = ops.equalize_histogram(ops.grayscale(img))
    return core.dither_pack_batch(eq[None])[0]


@batch_form(print_ready_p4)
def print_ready_p4_batch(imgs: torch.Tensor) -> torch.Tensor:
    """``print_ready_p4`` of each image of uint8[N, H, W, 3]: K8, K4 and K3,
    then K10, each once over the batch."""
    return core.dither_pack_batch(equalize_histogram_batch(ops.grayscale(imgs)))


PRESETS = {
    "edge_detect": edge_detect,
    "enhance": enhance,
    "thumbnail": functools.partial(thumbnail, width=THUMBNAIL_WIDTH),
    "print_ready": print_ready,
}

@batch_form(PRESETS["thumbnail"])
def thumbnail_batch(imgs: torch.Tensor) -> torch.Tensor:
    """``thumbnail`` of each image of uint8[N, H, W, 3]: K9's two passes,
    each one launch over the batch."""
    return ops.resize_width_batch(imgs, THUMBNAIL_WIDTH)


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


# P4 presets whose rows one pass dithers and packs: serving runs this form
# in place of the preset and its P4 packing. The reference ``-mono`` path
# (flips after the dither) and the band pipelines (a dither per band) keep
# the dither and the packing apart.
PRESET_P4_FORMS = {
    "print_ready": print_ready_p4,
}


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
