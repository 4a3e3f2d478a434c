"""Flagship fused pipeline: grayscale -> 5x5 Gaussian -> histogram equalize.

Counterpart of ``imageprocessingtools_tpu/kernels/fused.py``. The three
forms map uint8[H, W, 3] to uint8[H, W] and give the same bytes:

- ``fused_pipeline``: the plain torch versions, stage by stage (the JAX
  package's ``fused_pipeline_xla``); it launches no kernel on any device;
- ``fused_pipeline_staged``: K8 (``grayscale``), K5, K4, the equalization
  LUT, then K3 (the JAX package's ``fused_pipeline_pallas``, whose gray
  stage XLA fuses);
- ``fused_pipeline_mega``: K2 (gray + Gaussian + histogram in one pass),
  the equalization LUT, then K3 (the JAX package's
  ``fused_pipeline_pallas_mega``).

``fused_pipeline_mega_batch`` is the mega form's batch form
(``utils/graphs.py::batch_form``), the counterpart of ``jax.vmap`` of
``fused_pipeline_pallas_mega`` (``imageprocessingtools_tpu/parallel/
batch.py:95 batched_fused_pipeline``): uint8[N, H, W, 3] -> uint8[N, H, W]
through K2, the LUTs and K3, each launched once over the batch.

The JAX package exports them as ``jax.jit`` programs, one dispatch of one
executable per call. Their counterparts here are CUDA graphs
(``utils/graphs.py::graphed``): on a CUDA tensor one replay of a captured
graph (the input copied in, the output cloned out), on a CPU tensor the
eager form:

- ``fused_gray_gauss_histeq_pallas_mega``: the graphed mega form;
- ``fused_gray_gauss_histeq_pallas``: the graphed staged form;
- ``fused_gray_gauss_histeq`` (the JAX package's jitted XLA form): the
  port has no XLA form, so this is the graphed mega form, which gives the
  same bytes.
"""

from __future__ import annotations

import math

import torch

from imageprocessingtools_tpu_torch.kernels import core
from imageprocessingtools_tpu_torch.ops.color import grayscale
from imageprocessingtools_tpu_torch.ops.histogram import _equalize_lut
from imageprocessingtools_tpu_torch.utils.graphs import batch_form, graphed


def fused_pipeline(img: torch.Tensor) -> torch.Tensor:
    """uint8[H, W, 3] -> uint8[H, W] with the plain torch versions."""
    blurred = core.gray_gauss_plain(img)
    lut = _equalize_lut(core.histogram_plain(blurred), math.prod(blurred.shape))
    return core.lut_apply_plain(blurred, lut)


def fused_pipeline_staged(img: torch.Tensor) -> torch.Tensor:
    """uint8[H, W, 3] -> uint8[H, W] through K8, K5, K4 and K3."""
    blurred = core.gaussian_blur(grayscale(img))
    lut = _equalize_lut(core.histogram(blurred), math.prod(blurred.shape))
    return core.lut_apply(blurred, lut)


def fused_pipeline_mega(img: torch.Tensor) -> torch.Tensor:
    """uint8[H, W, 3] -> uint8[H, W] through K2 and K3."""
    blurred, hist = core.gray_gauss_hist(img)
    lut = _equalize_lut(hist, math.prod(blurred.shape))
    return core.lut_apply(blurred, lut)


@batch_form(fused_pipeline_mega)
def fused_pipeline_mega_batch(imgs: torch.Tensor) -> torch.Tensor:
    """uint8[N, H, W, 3] -> uint8[N, H, W], each image as
    ``fused_pipeline_mega``: K2 and K3 once each over the batch."""
    blurred, hists = core.gray_gauss_hist_batch(imgs)
    luts = _equalize_lut(hists, math.prod(blurred.shape[1:]))
    return core.lut_apply_batch(blurred, luts)


fused_gray_gauss_histeq_pallas_mega = graphed(fused_pipeline_mega)
fused_gray_gauss_histeq_pallas = graphed(fused_pipeline_staged)
fused_gray_gauss_histeq = fused_gray_gauss_histeq_pallas_mega
