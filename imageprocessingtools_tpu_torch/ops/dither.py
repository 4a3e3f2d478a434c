"""Bayer 4x4 ordered dithering to bilevel (``ppmx-edward.c:949-971``).

Counterpart of ``imageprocessingtools_tpu/ops/dither.py``. The threshold of
pixel (y, x) is ``BAYER_THRESHOLD_INT[y % 4, x % 4]`` (integer thresholds
that reproduce the reference's double comparison exactly, see
``ops/_exact.py``), indexed on the device rather than tiled on the host. The
table is made once per device, so that a CUDA graph can capture the dither
(``utils/graphs.py``). The dither is the span ``dither.mono``
(``utils.profiling``): on a card it runs at a capture of a graph of the
task, never at a replay.
"""

from __future__ import annotations

import functools

import torch

from imageprocessingtools_tpu_torch.ops import _exact
from imageprocessingtools_tpu_torch.utils.profiling import span


@functools.cache
def _thresholds(device: torch.device) -> torch.Tensor:
    """int32[4, 4] ``BAYER_THRESHOLD_INT`` on ``device``, made once per device."""
    return torch.as_tensor(_exact.BAYER_THRESHOLD_INT, device=device)


def mono_dither(img: torch.Tensor) -> torch.Tensor:
    """uint8[..., H, W, 3] -> uint8[..., H, W] in {0, 1}, 1 = black.
    Bit-exact. Leading axes are a batch: each image is dithered on its own
    (the JAX ``mono_dither`` under ``jax.vmap``)."""
    h, w = img.shape[-3], img.shape[-2]
    with span("dither.mono"):
        # r + g + b <= 765 in int16, channel by channel: no int32 copy of the
        # image (a batch's temporaries grow with the batch).
        avg = (img[..., 0].to(torch.int16) + img[..., 1] + img[..., 2]) // 3
        table = _thresholds(img.device)
        ys = torch.arange(h, device=img.device) % 4
        xs = torch.arange(w, device=img.device) % 4
        return (avg < table[ys[:, None], xs[None, :]]).to(torch.uint8)
