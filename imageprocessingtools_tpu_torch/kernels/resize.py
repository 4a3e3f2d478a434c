"""K9: one separable resize pass — the CUDA kernel's wrapper and its plain version.

The JAX package has no Pallas kernel for resize: its device path multiplies by
dense weight matrices (``imageprocessingtools_tpu/ops/resize.py::_apply_pass``,
float32, a budget of 2) and its exact mode is a host loop. The kernel here is
``csrc/resize.cu``. Both versions compute the reference's tap sum
(``ppmx-edward.c:820-868``, ``golden/model.py::_apply_contributions``) from
the tables of ``ops/_exact.py::calc_contributions``, in f64, tap by tap in the
table's order, every product and sum rounded on its own, so both are
byte-identical to the C. ``resize_pass`` takes the plain version for a CPU
tensor and launches the kernel for a CUDA tensor. ``device_passes`` keeps each
geometry's two tables on the device, so only a geometry's first call uploads
anything.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from imageprocessingtools_tpu_torch.kernels import _build
from imageprocessingtools_tpu_torch.ops import _exact
from imageprocessingtools_tpu_torch.ops.common import quantize_u8

_THREADS, _VEC, _ROWS = 128, 8, 4  # the kernel's block shapes (csrc/resize.cu)
_MAX_BLOCKS = 2**31 - 1            # a one-dimensional grid


def hw_passes(height: int, width: int, new_height: int, new_width: int):
    """Both contribution passes for an explicit (H, W) target, smaller scale
    first (the reference's ``-wN`` ordering rule, applied generally)."""
    scale_h = float(new_height) / float(height)
    scale_w = float(new_width) / float(width)
    contrib_h = _exact.calc_contributions(height, new_height, scale_h)
    contrib_w = _exact.calc_contributions(width, new_width, scale_w)
    if scale_h < scale_w:
        return ((0, contrib_h), (1, contrib_w))
    return ((1, contrib_w), (0, contrib_h))


@functools.lru_cache(maxsize=32)
def device_passes(height: int, width: int, target, device: torch.device):
    """((dim, idx int32[out, taps], w float64[out, taps]), ...) on ``device``,
    in pass order. ``target`` is a new width (``-wN``: the height follows,
    ``_exact.plan_resize``, which raises the reference's B7/B9 messages) or a
    (new_height, new_width) pair."""
    if isinstance(target, tuple):
        passes = hw_passes(height, width, *target)
    else:
        passes = _exact.plan_resize(height, width, target).passes
    return tuple(
        (dim, torch.from_numpy(np.ascontiguousarray(contrib.indices, dtype=np.int32)).to(device),
         torch.from_numpy(np.ascontiguousarray(contrib.weights)).to(device))
        for dim, contrib in passes)


def resize_pass_plain(img: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                      dim: int) -> torch.Tensor:
    """Plain torch form of K9, on the input's device: f64, one gather, one
    multiply and one add per tap (separate ops, so each rounds; never a fused
    or reordered sum), byte-identical to ``golden._apply_contributions``.

    uint8[H, W(, C)] -> uint8 with axis ``dim`` resized to ``idx.shape[0]``.
    """
    out_size, taps = idx.shape
    shape = list(img.shape)
    shape[dim] = out_size
    weight_shape = [1] * img.ndim
    weight_shape[dim] = out_size
    acc = torch.zeros(shape, dtype=torch.float64, device=img.device)
    for z in range(taps):
        src = img.index_select(dim, idx[:, z].to(torch.int64)).to(torch.float64)
        prod = src * w[:, z].reshape(weight_shape)
        acc = acc + prod
    return quantize_u8(acc)


def resize_pass(img: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, dim: int) -> torch.Tensor:
    """One pass of a separable resize along ``dim`` (0 or 1): K9 on a CUDA
    tensor, the plain version on a CPU tensor. ``img`` is a contiguous
    uint8[H, W, C] (C 1 or 3) or uint8[H, W]; ``idx`` int32[out, taps] and
    ``w`` float64[out, taps] lie on its device."""
    if dim not in (0, 1):
        raise ValueError(f"resize_pass: dim must be 0 or 1, got {dim}")
    if img.device.type == "cpu":
        return resize_pass_plain(img, idx, w, dim)
    if img.device.type != "cuda":
        raise TypeError(f"resize_pass: unsupported device {img.device}")
    if img.dtype != torch.uint8 or img.ndim not in (2, 3) or not img.is_contiguous():
        raise TypeError(
            f"resize_pass: need a contiguous uint8[H, W(, C)] tensor, got "
            f"{img.dtype} {tuple(img.shape)} contiguous={img.is_contiguous()}")
    squeeze = img.ndim == 2
    rows, cols = img.shape[0], img.shape[1]
    c = 1 if squeeze else img.shape[2]
    if c not in (1, 3):
        raise TypeError(f"resize_pass: the kernel takes 1 or 3 channels, got {c}")
    if (idx.dtype != torch.int32 or w.dtype != torch.float64 or idx.ndim != 2
            or idx.shape != w.shape or idx.device != img.device or w.device != img.device
            or not idx.is_contiguous() or not w.is_contiguous()):
        raise TypeError(
            f"resize_pass: need contiguous idx int32[out, taps] and w float64[out, taps] on "
            f"{img.device}, got {idx.dtype} {tuple(idx.shape)} on {idx.device} and "
            f"{w.dtype} {tuple(w.shape)} on {w.device}")
    out_size, taps = idx.shape
    out_shape = (out_size, cols, c) if dim == 0 else (rows, out_size, c)
    out = torch.empty(out_shape, dtype=torch.uint8, device=img.device)
    if out.numel():
        if taps < 1 or img.numel() == 0:
            raise ValueError(f"resize_pass: no taps or no source for a {out_shape} output")
        if dim == 0:
            blocks = out_size * -(-cols * c // (_THREADS * _VEC))
        else:
            blocks = -(-out_size // _THREADS) * -(-rows // _ROWS)
        if blocks > _MAX_BLOCKS or taps >= 2**31:
            raise RuntimeError(
                f"resize_pass: {rows}x{cols}x{c} -> {out_shape} with {taps} taps is too "
                f"large for one launch")
        status = _build.library().ipt_resize_pass(
            img.data_ptr(), out.data_ptr(), idx.data_ptr(), w.data_ptr(), rows, cols, c,
            out_size, taps, dim, img.device.index,
            torch.cuda.current_stream(img.device).cuda_stream)
        _build.check(status, "ipt_resize_pass")
        resize_pass.launches += 1
    return out[:, :, 0] if squeeze else out


resize_pass.launches = 0
