"""Fixed-order op pipeline mirroring the reference's main loop.

Counterpart of ``imageprocessingtools_tpu/pipeline.py``. The reference
applies ops in a FIXED order regardless of CLI order
(``ppmx-edward.c:1084-1155``): resize -> rotate -> gray -> mono -> flip-v ->
flip-h.

Intentional divergence (bug B1, as in the JAX package): in the reference, a
flip combined with -gray/-mono clobbers the gray/mono result with the color
buffer's red channel (``ppmx-edward.c:896`` aliasing + the guard at
``:1147-1155``). This pipeline composes: flips apply to the gray/mono output.

``run_pipeline_batch`` is ``jax.vmap(run_pipeline)``: the same order over a
batch of one shape, each stage one op over the batch (K9, K1 and K8 launched
once per stage for the whole batch on a card) and one ``pipeline.<stage>``
span.
"""

from __future__ import annotations

import dataclasses

import torch

from imageprocessingtools_tpu_torch import ops
from imageprocessingtools_tpu_torch.codec.ppm import FILETYPE_PBM, FILETYPE_PGM, FILETYPE_PPM
from imageprocessingtools_tpu_torch.device import get_device
from imageprocessingtools_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The reference's six-flag surface (``ppmx-edward.c:59-66``)."""

    new_width: int | None = None   # -wN
    angle: float | None = None     # -rN (reference CLI: integer 0..359)
    gray: bool = False             # -gray (conflicts with mono)
    mono: bool = False             # -mono (conflicts with gray)
    flip_v: bool = False           # -fv (conflicts with fh)
    flip_h: bool = False           # -fh (conflicts with fv)

    def __post_init__(self):
        if self.gray and self.mono:
            raise ValueError("Error: Conflicting options not allowed\n")
        if self.flip_v and self.flip_h:
            raise ValueError("Error: Conflicting options not allowed\n")

    @property
    def any_op(self) -> bool:
        return (
            self.new_width is not None
            or self.angle is not None
            or self.gray
            or self.mono
            or self.flip_v
            or self.flip_h
        )

    @property
    def file_type(self) -> int:
        if self.gray:
            return FILETYPE_PGM
        if self.mono:
            return FILETYPE_PBM
        return FILETYPE_PPM


def run_pipeline(img, config: PipelineConfig) -> tuple[torch.Tensor, int]:
    """Apply the fixed-order pipeline; returns (result, file_type).

    ``img`` is uint8[H, W, 3] (numpy or torch). It moves once to the
    configured device (``device.get_device``), where every stage runs.
    Raises ValueError with the reference's message when no op is requested
    (quirk B2: the reference errors with "no data to write").
    """
    if not config.any_op:
        raise ValueError("Error: no data to write\n")
    out = torch.as_tensor(img).to(get_device())
    if config.new_width is not None:
        out = ops.resize_width(out, int(config.new_width))
    if config.angle is not None:
        out = ops.rotate(out, float(config.angle))
    if config.gray:
        out = ops.grayscale(out)
    if config.mono:
        out = ops.mono_dither(out)
    if config.flip_v:
        out = ops.flip_vertical(out)
    if config.flip_h:
        out = ops.flip_horizontal(out)
    return out, config.file_type


def run_pipeline_batch(imgs, config: PipelineConfig) -> tuple[torch.Tensor, int]:
    """``run_pipeline`` of each image of uint8[N, H, W, 3] (numpy or torch),
    in the same fixed order through the ops' batch forms; returns
    (uint8[N, ...], file_type). Raises as ``run_pipeline`` does. Each stage
    is a ``pipeline.<stage>`` span (``utils.profiling``): on a card it runs
    when a graph of the task is captured, not when it is replayed."""
    if not config.any_op:
        raise ValueError("Error: no data to write\n")
    out = torch.as_tensor(imgs).to(get_device())
    if config.new_width is not None:
        with span("pipeline.resize"):
            out = ops.resize_width_batch(out, int(config.new_width))
    if config.angle is not None:
        with span("pipeline.rotate"):
            out = ops.rotate_batch(out, float(config.angle))
    if config.gray:
        with span("pipeline.gray"):
            out = ops.grayscale(out)
    if config.mono:
        with span("pipeline.mono"):
            out = ops.mono_dither(out)
    if config.flip_v:
        with span("pipeline.flip_v"):
            out = ops.flip_vertical_batch(out)
    if config.flip_h:
        with span("pipeline.flip_h"):
            out = ops.flip_horizontal_batch(out)
    return out, config.file_type
