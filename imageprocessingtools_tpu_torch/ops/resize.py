"""Separable bicubic resize: ``-wN`` and an explicit (H, W) target, exact.

Counterpart of ``imageprocessingtools_tpu/ops/resize.py``. The reference's
taps (``ppmx-edward.c:516-641``, ``_exact.calc_contributions``) are applied as
they are, one pass per axis through ``kernels/resize.py::resize_pass`` (K9 on
a CUDA tensor): f64 sums in the C's tap order, the smaller scale first, with
the reference's uint8 requantization between the passes
(``ppmx-edward.c:1102-1120``). Every geometry takes this one path and every
result is byte-identical to the C, so the port has no inexact op and no
budget. The tables stay on the device per geometry; nothing leaves it.
``resize_width_batch`` and ``resize_batch`` resize each image of a batch of
one shape with one launch per pass for the whole batch
(``kernels/resize.py::resize_pass_batch``), as ``jax.vmap`` of the JAX
package's resize is one op over the batch.

The JAX package multiplies by dense float32 weight matrices instead, because
the TPU has a matrix unit and neither f64 nor a fast gather; that form is kept
here as ``resize_width_dense``, a yardstick for K9's time that no path calls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from imageprocessingtools_tpu_torch.kernels import resize as _k9
from imageprocessingtools_tpu_torch.ops import _exact
from imageprocessingtools_tpu_torch.ops.common import quantize_u8


def _apply(img: torch.Tensor, target) -> torch.Tensor:
    out = img.contiguous()
    for dim, idx, w in _k9.device_passes(img.shape[0], img.shape[1], target, img.device):
        out = _k9.resize_pass(out, idx, w, dim)
    return out


def _apply_batch(imgs: torch.Tensor, target) -> torch.Tensor:
    """``_apply`` of each image of uint8[N, H, W(, C)]: the same passes, each
    one launch over the batch, the same uint8 image between them."""
    out = imgs.contiguous()
    for dim, idx, w in _k9.device_passes(imgs.shape[1], imgs.shape[2], target, imgs.device):
        out = _k9.resize_pass_batch(out, idx, w, dim)
    return out


def resize_width(img: torch.Tensor, new_width: int) -> torch.Tensor:
    """Resize to ``new_width``; height = trunc(H * new_width / W) (B6).

    MATLAB-imresize-compatible bicubic with antialiasing on downscale and
    mirror boundaries, byte-identical to the C; raises the reference's B7/B9
    messages as ValueError. uint8[H, W, C] or uint8[H, W].
    """
    return _apply(img, int(new_width))


def resize_width_exact(img: torch.Tensor, new_width: int) -> torch.Tensor:
    """``resize_width`` under the JAX package's name for its f64 mode (a host
    loop there, since the TPU has no f64; here the one path is already exact)."""
    return resize_width(img, new_width)


def resize_width_batch(imgs: torch.Tensor, new_width: int) -> torch.Tensor:
    """``resize_width`` of each image of uint8[N, H, W, C] or uint8[N, H, W],
    each pass one launch over the batch."""
    return _apply_batch(imgs, int(new_width))


def _explicit_target(new_height: int, new_width: int) -> tuple:
    new_height, new_width = int(new_height), int(new_width)
    if new_height < 1 or new_width < 1:
        raise ValueError("invalid option for new width\n")
    if (
        max(new_height, new_width) > _exact._MAX_RESIZE_DIM
        or new_height * new_width > _exact._MAX_RESIZE_OUT_PX
    ):
        raise ValueError(
            f"resize output {new_height}x{new_width} exceeds the supported "
            f"bound (dim <= 2^26, pixels <= 2^31)"
        )
    return new_height, new_width


def resize(img: torch.Tensor, new_height: int, new_width: int) -> torch.Tensor:
    """Library extension: resize to an explicit (new_height, new_width), with
    the same taps, pass order and exact sums as ``resize_width``. Outputs
    beyond the resource caps raise up front (a clear extension message, not
    the ``-wN`` parity surface)."""
    return _apply(img, _explicit_target(new_height, new_width))


def resize_batch(imgs: torch.Tensor, new_height: int, new_width: int) -> torch.Tensor:
    """``resize`` of each image of uint8[N, H, W, C] or uint8[N, H, W], each
    pass one launch over the batch."""
    return _apply_batch(imgs, _explicit_target(new_height, new_width))


@functools.lru_cache(maxsize=8)
def _dense_device_weights(height: int, width: int, new_width: int, device: torch.device):
    """((dim, float32[out, in] on ``device``), ...) in pass order."""
    plan = _exact.plan_resize(height, width, new_width)
    return tuple(
        (dim, torch.from_numpy(
            _exact.dense_weights(contrib, height if dim == 0 else width).astype(np.float32)
        ).to(device))
        for dim, contrib in plan.passes)


def resize_width_dense(img: torch.Tensor, new_width: int) -> torch.Tensor:
    """``resize_width`` in the JAX package's dense form: two float32 matrix
    products (TF32 off, see ``device.py``) by the taps scattered into
    [out, in] matrices, which stay on the device per geometry. Within 2 of
    ``resize_width`` (each quantized pass may round one step the other way).
    A yardstick for K9's time; no path of the port calls it."""
    out = img
    for dim, weight in _dense_device_weights(img.shape[0], img.shape[1], int(new_width),
                                             img.device):
        squeeze = out.ndim == 2
        src = (out[:, :, None] if squeeze else out).to(torch.float32)
        pattern = "oh,hwc->owc" if dim == 0 else "ow,hwc->hoc"
        out = quantize_u8(torch.einsum(pattern, weight, src)).contiguous()
        out = out[:, :, 0] if squeeze else out
    return out
