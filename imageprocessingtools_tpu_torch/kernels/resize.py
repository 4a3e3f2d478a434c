"""K9: one separable resize pass — the CUDA kernel's wrapper and its plain version.

The JAX package has no Pallas kernel for resize: its device path multiplies by
dense weight matrices (``imageprocessingtools_tpu/ops/resize.py::_apply_pass``,
float32, a budget of 2) and its exact mode is a host loop. The kernel here is
``csrc/resize.cu``. Both versions compute the reference's tap sum
(``ppmx-edward.c:820-868``, ``golden/model.py::_apply_contributions``) from
the tables of ``ops/_exact.py::calc_contributions``, in f64, tap by tap in the
table's order, every product and sum rounded on its own, so both are
byte-identical to the C. ``resize_pass`` takes the plain version for a CPU
tensor and launches the kernel for a CUDA tensor. ``resize_pass_batch`` is the
same pass over each image of a batch of one shape in one launch with the same
tables (``jax.vmap``'s one op over the batch). ``device_passes`` keeps each
geometry's two tables on the device, so only a geometry's first call uploads
anything. ``cols_paths`` counts the W-pass launches by the path that the C
host code plans for them from the shape (``csrc/cols_plan.cuh``): tiled
(source rows staged in shared memory) or gathered.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from imageprocessingtools_tpu_torch.kernels import _build, core
from imageprocessingtools_tpu_torch.ops import _exact
from imageprocessingtools_tpu_torch.ops.common import quantize_u8
from imageprocessingtools_tpu_torch.utils import graphs

_THREADS = 128               # dim 0: threads a block (csrc/resize.cu)
_VECS = (8, 4, 2, 1)         # dim 0: the bytes per thread that the kernel takes, most first
_BLOCKS_PER_SM = 4           # dim 0: the fewest blocks per SM that rows_vec aims at
_MAX_BLOCKS = 2**31 - 1      # a one-dimensional grid
# W-pass launches by the path of their plan (``csrc/cols_plan.cuh``): "tiled"
# and "gathered". Counted where the launch is made: under a graph at its
# capture.
cols_paths = collections.Counter()


def rows_vec(out_size: int, row_bytes: int, sms: int) -> int:
    """dim 0's bytes per thread: the most of ``_VECS`` whose grid still gives
    each of ``sms`` SMs ``_BLOCKS_PER_SM`` blocks of ``_THREADS`` threads
    (fewer bytes a thread, more blocks), else 1. 8 at 4K -> 1920 and 1080p ->
    3840; 1 at 4K -> 256 (144 rows of 768 bytes)."""
    for vec in _VECS:
        if out_size * -(-row_bytes // (_THREADS * vec)) >= _BLOCKS_PER_SM * sms:
            return vec
    return 1


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def cols_path(cols: int, c: int, out_size: int, taps: int, device: int) -> str:
    """The path, "tiled" or "gathered", that the W pass over rows of ``cols``
    pixels of ``c`` channels to ``out_size`` with ``taps`` taps takes on CUDA
    card ``device``: the C host code's plan (``ipt_resize_cols_tiled``)."""
    tiled = ctypes.c_int()
    _build.check(_build.library().ipt_resize_cols_tiled(cols, c, out_size, taps, device,
                                                        ctypes.addressof(tiled)),
                 "ipt_resize_cols_tiled")
    return "tiled" if tiled.value else "gathered"


def pass_vec(img: torch.Tensor, out_size: int, dim: int, n: int = 1) -> int:
    """dim 0's bytes per thread for ``n`` images of ``img``'s shape
    (uint8[H, W(, C)] on a CUDA device) in one launch: ``rows_vec`` of the
    launch's ``n * out_size`` output rows on its card's SMs; 0 for dim 1."""
    if dim != 0:
        return 0
    return rows_vec(n * out_size, img.shape[1] * (img.shape[2] if img.ndim == 3 else 1),
                    _sm_count(img.device))


def launch_limit(rows: int, cols: int, c: int, out_size: int, taps: int, dim: int,
                 vec: int, n: int = 1) -> str | None:
    """Why one launch of K9 along ``dim`` cannot take ``n`` images of
    uint8[rows, cols, c] to ``out_size`` with ``taps`` taps (``vec`` bytes a
    thread along dim 0), or None: along dim 0 an image's grid is
    one-dimensional and the image is a grid axis of at most
    ``core.MAX_BATCH`` (along dim 1 the batch's rows are one image's, walked
    by one wave of blocks), and the tap count is an int."""
    blocks = out_size * -(-cols * c // (_THREADS * vec)) if dim == 0 else 0
    if blocks > _MAX_BLOCKS:
        return f"{blocks} blocks exceed a one-dimensional grid"
    if dim == 0 and core.batch_limit(n):
        return core.batch_limit(n)
    if taps > _build.INT_MAX:
        return f"{taps} taps do not fit a C int"
    return None


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


@graphs.device_table(maxsize=32)
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


def resize_pass_batch_plain(imgs: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                            dim: int) -> torch.Tensor:
    """Plain torch form of K9 over a batch: ``resize_pass_plain`` along image
    axis ``dim`` of each image of uint8[N, H, W(, C)], in one call (every
    output byte takes the same f64 operations as in the single image's)."""
    return resize_pass_plain(imgs, idx, w, dim + 1)


def launch_args(img: torch.Tensor, out: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                dim: int, vec: int | None = None) -> tuple:
    """``ipt_resize_pass``'s arguments for one pass of ``img`` (uint8[H, W, C]
    or [H, W], on a CUDA device) into ``out``; dim 0 with ``vec`` bytes per
    thread, by default ``pass_vec``'s."""
    if vec is None:
        vec = pass_vec(img, idx.shape[0], dim)
    return (img.data_ptr(), out.data_ptr(), idx.data_ptr(), w.data_ptr(), img.shape[0],
            img.shape[1], 1 if img.ndim == 2 else img.shape[2], idx.shape[0], idx.shape[1], dim,
            vec, img.device.index, torch.cuda.current_stream(img.device).cuda_stream)


def _checked(name: str, img: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
             ndim: int) -> int:
    """The channels of ``img`` (``_build.image_channels``), with ``idx``
    int32[out, taps] and ``w`` float64[out, taps] contiguous on its device;
    raises on anything else."""
    c = _build.image_channels(name, img, ndim)
    if (idx.dtype != torch.int32 or w.dtype != torch.float64 or idx.ndim != 2
            or idx.shape != w.shape or idx.device != img.device or w.device != img.device
            or not idx.is_contiguous() or not w.is_contiguous()):
        raise TypeError(
            f"{name}: need contiguous idx int32[out, taps] and w float64[out, taps] on "
            f"{img.device}, got {idx.dtype} {tuple(idx.shape)} on {idx.device} and "
            f"{w.dtype} {tuple(w.shape)} on {w.device}")
    return c


def resize_pass(img: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, dim: int) -> torch.Tensor:
    """One pass of a separable resize along ``dim`` (0 or 1): K9 on a CUDA
    tensor, the plain version on a CPU tensor. ``img`` is a contiguous
    uint8[H, W, C] (C 1 or 3) or uint8[H, W]; ``idx`` int32[out, taps] and
    ``w`` float64[out, taps] lie on its device."""
    if dim not in (0, 1):
        raise ValueError(f"resize_pass: dim must be 0 or 1, got {dim}")
    if img.device.type == "cpu":
        return resize_pass_plain(img, idx, w, dim)
    c = _checked("resize_pass", img, idx, w, 2)
    squeeze = img.ndim == 2
    rows, cols = img.shape[0], img.shape[1]
    out_size, taps = idx.shape
    out_shape = (out_size, cols, c) if dim == 0 else (rows, out_size, c)
    out = torch.empty(out_shape, dtype=torch.uint8, device=img.device)
    if out.numel():
        if taps < 1 or img.numel() == 0:
            raise ValueError(f"resize_pass: no taps or no source for a {out_shape} output")
        vec = pass_vec(img, out_size, dim)
        reason = launch_limit(rows, cols, c, out_size, taps, dim, vec)
        if reason:
            raise _build.TooLarge(
                f"resize_pass: {rows}x{cols}x{c} -> {out_shape} with {taps} taps is too "
                f"large for one launch: {reason}")
        status = _build.library().ipt_resize_pass(*launch_args(img, out, idx, w, dim, vec))
        _build.check(status, "ipt_resize_pass")
        resize_pass.launches += 1
        if dim == 1:
            cols_paths[cols_path(cols, c, out_size, taps, img.device.index)] += 1
    return out[:, :, 0] if squeeze else out


def resize_pass_batch(imgs: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                      dim: int) -> torch.Tensor:
    """``resize_pass`` along image axis ``dim`` (0 or 1) of each image of
    ``imgs``, a contiguous uint8[N, H, W, C] (C 1 or 3) or uint8[N, H, W]:
    one launch of K9 over the batch with the same tables on a CUDA tensor,
    the plain batch version on a CPU tensor."""
    if dim not in (0, 1):
        raise ValueError(f"resize_pass_batch: dim must be 0 or 1, got {dim}")
    if imgs.device.type == "cpu":
        return resize_pass_batch_plain(imgs, idx, w, dim)
    c = _checked("resize_pass_batch", imgs, idx, w, 3)
    squeeze = imgs.ndim == 3
    n, rows, cols = imgs.shape[:3]
    out_size, taps = idx.shape
    out_shape = (n, out_size, cols, c) if dim == 0 else (n, rows, out_size, c)
    out = torch.empty(out_shape, dtype=torch.uint8, device=imgs.device)
    if out.numel():
        if taps < 1 or imgs.numel() == 0:
            raise ValueError(f"resize_pass_batch: no taps or no source for a {out_shape} output")
        vec = pass_vec(imgs[0], out_size, dim, n)
        reason = launch_limit(rows, cols, c, out_size, taps, dim, vec, n)
        if reason:
            raise _build.TooLarge(
                f"resize_pass_batch: {n}x{rows}x{cols}x{c} -> {out_shape} with {taps} taps is "
                f"too large for one launch: {reason}")
        status = _build.library().ipt_resize_pass_batch(
            imgs.data_ptr(), out.data_ptr(), idx.data_ptr(), w.data_ptr(), n, rows, cols, c,
            out_size, taps, dim, vec, imgs.device.index,
            torch.cuda.current_stream(imgs.device).cuda_stream)
        _build.check(status, "ipt_resize_pass_batch")
        resize_pass_batch.launches += 1
        if dim == 1:
            cols_paths[cols_path(cols, c, out_size, taps, imgs.device.index)] += 1
    return out[..., 0] if squeeze else out


resize_pass.launches = 0
resize_pass_batch.launches = 0
