"""K2-K8: CUDA wrappers of the flagship's, the presets' and the gray
stage's kernels, and their plain versions.

Counterpart of ``imageprocessingtools_tpu/kernels/pallas_core.py``:

- K2 ``gray_gauss_hist`` (``csrc/gray_gauss_hist.cu``) replaces
  ``gray_gauss_hist_pallas``: uint8[H, W, 3] -> (blurred gray uint8[H, W],
  its int32[256] histogram) in one pass;
- K6 ``gray_gauss`` (``csrc/gray_gauss_hist.cu``, K2's tile kernel without
  the histogram) replaces ``gray_gauss_pallas``: uint8[H, W, 3] -> blurred
  gray uint8[H, W];
- K3 ``lut_apply`` (``csrc/lut_apply.cu``) replaces ``lut_apply_pallas``:
  uint8 values through a uint8[256] LUT;
- K4 ``histogram`` (``csrc/histogram.cu``) replaces ``histogram_pallas``:
  uint8 values -> int32[256], every bin stored by the launch (no zeroed
  output); under CUDA graph capture it gets arrival words of its own;
- K5 ``gaussian_blur`` (``csrc/stencil.cu``, K2/K6's tile without the gray
  step; the packed arithmetic they share is ``csrc/gauss_tile.cuh``, the row
  staging ``csrc/bulk_copy.cuh``) replaces ``gaussian_blur_pallas``: the 5x5
  binomial on uint8[H, W];
- K7 ``box_blur``, ``sharpen`` and ``sobel`` (``csrc/stencil.cu``, one
  template) replace ``box_blur_pallas``, ``sharpen_pallas`` and
  ``sobel_pallas`` (``_make_stencil3``): 3x3 stencils on uint8[H, W];
- K8 ``fused_elementwise`` (``csrc/elementwise.cu``) replaces
  ``fused_elementwise_pallas``: uint8[..., 3] -> gray uint8[...] through a
  static chain of invert, brightness, contrast and threshold. With the
  empty chain it is ``ops.color.grayscale`` on a CUDA tensor;
- K10 ``dither_pack_batch`` (``csrc/dither_pack.cu``) replaces no Pallas
  kernel (the JAX package dithers and packs in jnp ops): print_ready's Bayer
  dither of an equalized gray uint8[N, H, W] and its MSB-first P4 packing
  in one pass, -> uint8[N, H, ceil(W / 8)].

K2, K6, K4, K3 and K7 also take a batch axis, the counterpart of
``jax.vmap`` over their Pallas kernels (whose batching rule adds a leading
grid axis): ``gray_gauss_hist_batch``, ``gray_gauss_batch``,
``histogram_batch``, ``lut_apply_batch``, ``box_blur_batch``,
``sharpen_batch`` and ``sobel_batch`` map uint8[N, ...] to outputs with a
leading N in one launch over the whole batch, each image on its own, as
the single-image wrapper maps it. Their plain versions (``*_batch_plain``)
are the single-image plain versions image by image, stacked. A batched
launch takes at most ``MAX_BATCH`` images (K3, K4, K7 and K10 put the image
on a grid axis); K2's and K6's limit is their tile count over the batch.

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA tensor. Offsets into an image are 64-bit in every kernel,
so an image of 2^31 bytes or more is one launch; what a launch cannot take
is in one pure function per kernel (``gray_gauss_limit``,
``gaussian_blur_limit``, ``stencil3_limit``), and the wrapper refuses it
with ``kernels.TooLarge``. The plain versions (``*_plain``) are built from
torch ops and each other only, never from a wrapper, so on a CUDA tensor
they launch none of these kernels and stay an independent reference. The
public ops (``ops/color.py``, ``ops/stencil.py``, ``ops/histogram.py``) call
the wrappers.

Stencil edges replicate (``np.pad`` mode "edge"); all arithmetic is int32
and integer-exact, as in ``imageprocessingtools_tpu/ops/stencil.py``.
"""

from __future__ import annotations

import functools

import torch

from imageprocessingtools_tpu_torch.kernels import _build
from imageprocessingtools_tpu_torch.ops import _exact
from imageprocessingtools_tpu_torch.ops.dither import mono_dither
from imageprocessingtools_tpu_torch.ops.packing import pack_bits_device
from imageprocessingtools_tpu_torch.utils import graphs
from imageprocessingtools_tpu_torch.utils.profiling import span

_MAX_GRID_Y = 65535 * 32  # image rows per K7 launch: grid.y tiles of 32 rows
MAX_BATCH = 65535  # images per batched K3, K4, K7 or K10 launch: a grid axis
_TILE_W, _TILE_H = 256, 16  # K2, K5 and K6's output tiles

_GAUSS_TAPS = (1, 4, 6, 4, 1)
_BOX = ((1, 1, 1),) * 3
_SHARPEN = ((0, -1, 0), (-1, 5, -1), (0, -1, 0))
_SOBEL_X = ((-1, 0, 1), (-2, 0, 2), (-1, 0, 1))
_SOBEL_Y = ((-1, -2, -1), (0, 0, 0), (1, 2, 1))


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def grayscale_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain torch form of K8's gray stage: uint8[..., 3] -> uint8[...], exact
    (r+g+b)//3. The sum is taken in int32: uint8 ``r+g+b`` wraps in torch."""
    return (img.to(torch.int32).sum(-1) // 3).to(torch.uint8)


def _chain_plain(v: torch.Tensor, chain) -> torch.Tensor:
    """int32 gray values through ``chain``, op for op as
    ``pallas_core._elementwise_kernel``. Contrast is an f32 subtract, multiply
    and add, each its own torch op (so each rounds), with the factor rounded
    to f32 as JAX's weak-typed ``float(arg)`` is."""
    for op, arg in chain:
        if op == "invert":
            v = 255 - v
        elif op == "brightness":
            v = (v + int(arg)).clamp(0, 255)
        elif op == "contrast":
            factor = torch.tensor(float(arg), dtype=torch.float32)
            vf = (v.to(torch.float32) - 128.0) * factor + 128.0
            v = torch.floor(vf + 0.5).clamp(0.0, 255.0).to(torch.int32)
        elif op == "threshold":
            v = torch.where(v >= int(arg), 255, 0).to(torch.int32)
        else:
            raise ValueError(f"unknown op {op}")
    return v


def fused_elementwise_plain(img: torch.Tensor, chain=()) -> torch.Tensor:
    """Plain torch form of K8: gray of uint8[..., 3], then ``chain``."""
    gray = grayscale_plain(img)
    if not chain:
        return gray
    return _chain_plain(gray.to(torch.int32), chain).to(torch.uint8)


def _pad_edge(img: torch.Tensor, r: int) -> torch.Tensor:
    """Replicate-pad the first two dims by ``r`` (np.pad mode="edge")."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.arange(-r, h + r, device=img.device).clamp(0, h - 1)
    xs = torch.arange(-r, w + r, device=img.device).clamp(0, w - 1)
    return img[ys][:, xs]


def _window_sum(src: torch.Tensor, h: int, w: int, weights) -> torch.Tensor:
    """sum over (dy, dx) of weights[dy][dx] * src[dy:dy+h, dx:dx+w], int32."""
    acc = None
    for dy, row in enumerate(weights):
        for dx, coeff in enumerate(row):
            if coeff == 0:
                continue
            tap = src[dy : dy + h, dx : dx + w]
            term = tap if coeff == 1 else coeff * tap
            acc = term if acc is None else acc + term
    return acc


def gaussian_blur_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain torch form of K5: two integer passes, one rounding shift."""
    h, w = img.shape[0], img.shape[1]
    src = _pad_edge(img.to(torch.int32), 2)
    rows = sum(k * src[dy : dy + h] for dy, k in enumerate(_GAUSS_TAPS))
    acc = sum(k * rows[:, dx : dx + w] for dx, k in enumerate(_GAUSS_TAPS))
    return ((acc + 128) >> 8).to(torch.uint8)


def box_blur_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain torch form of K7 box: floor(sum9 / 9 + 1/2) == (2*sum9 + 9) // 18."""
    h, w = img.shape[0], img.shape[1]
    s = _window_sum(_pad_edge(img.to(torch.int32), 1), h, w, _BOX)
    return ((2 * s + 9) // 18).to(torch.uint8)


def sharpen_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain torch form of K7 sharpen: [0,-1,0; -1,5,-1; 0,-1,0], clipped."""
    h, w = img.shape[0], img.shape[1]
    s = _window_sum(_pad_edge(img.to(torch.int32), 1), h, w, _SHARPEN)
    return s.clamp(0, 255).to(torch.uint8)


def _isqrt_round(m: torch.Tensor) -> torch.Tensor:
    """Exact round-half-up integer sqrt of int32 ``m``: f32 estimate, then
    the integer fix-up round_half_up(sqrt(m)) = k <=> k^2-k+1 <= m <= k^2+k
    (exact for m < 2^24; Sobel's m is at most 2,080,800)."""
    k = torch.floor(torch.sqrt(m.to(torch.float32)) + 0.5).to(torch.int32)
    k = torch.where(m > k * k + k, k + 1, k)
    # guard k > 0: the down-correction would take m = 0 to -1 (0 < 1)
    return torch.where((k > 0) & (m < k * k - k + 1), k - 1, k)


def sobel_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain torch form of K7 Sobel: clip(round_half_up(sqrt(gx^2 + gy^2)))."""
    h, w = img.shape[0], img.shape[1]
    src = _pad_edge(img.to(torch.int32), 1)
    gx = _window_sum(src, h, w, _SOBEL_X)
    gy = _window_sum(src, h, w, _SOBEL_Y)
    return _isqrt_round(gx * gx + gy * gy).clamp(0, 255).to(torch.uint8)


def _check_count(n: int) -> None:
    if n >= 2**31:
        # int32 bins (and the equalization CDF downstream) would wrap.
        raise ValueError("histogram requires < 2^31 total elements")


def histogram_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain torch form of K4: uint8[...] -> int32[256] bin counts."""
    _check_count(img.numel())
    return torch.bincount(img.reshape(-1), minlength=256).to(torch.int32)


def lut_apply_plain(values: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Plain torch form of K3: a gather (values in [0, 256))."""
    return lut.to(torch.uint8)[values.long()]


def gray_gauss_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain torch form of K6: gray -> Gaussian."""
    return gaussian_blur_plain(grayscale_plain(img))


def gray_gauss_hist_plain(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch form of K2: gray -> Gaussian, and the blur's histogram."""
    blurred = gray_gauss_plain(img)
    return blurred, histogram_plain(blurred)


def _stacked(outs: list, shape: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """Per-image outputs of ``shape`` stacked along a new leading axis
    (an empty [0, *shape] tensor for no images)."""
    if not outs:
        return torch.empty((0,) + tuple(shape), dtype=dtype, device=device)
    return torch.stack(outs)


def gray_gauss_batch_plain(imgs: torch.Tensor) -> torch.Tensor:
    """Plain torch form of K6 over a batch: ``gray_gauss_plain`` per image."""
    return _stacked([gray_gauss_plain(x) for x in imgs], imgs.shape[1:3], torch.uint8,
                    imgs.device)


def gray_gauss_hist_batch_plain(imgs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch form of K2 over a batch: ``gray_gauss_hist_plain`` per image."""
    outs = [gray_gauss_hist_plain(x) for x in imgs]
    return (_stacked([o[0] for o in outs], imgs.shape[1:3], torch.uint8, imgs.device),
            _stacked([o[1] for o in outs], (256,), torch.int32, imgs.device))


def histogram_batch_plain(values: torch.Tensor) -> torch.Tensor:
    """Plain torch form of K4 over a batch: uint8[N, ...] -> int32[N, 256],
    ``histogram_plain`` per image."""
    return _stacked([histogram_plain(v) for v in values], (256,), torch.int32, values.device)


def lut_apply_batch_plain(values: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Plain torch form of K3 over a batch: image i of uint8[N, ...] through
    row i of uint8[N, 256], ``lut_apply_plain`` per image."""
    return _stacked([lut_apply_plain(v, lut) for v, lut in zip(values, luts)],
                    values.shape[1:], torch.uint8, values.device)


def dither_pack_batch_plain(gray: torch.Tensor) -> torch.Tensor:
    """Plain torch form of K10: print_ready's dither of uint8[N, H, W] (the
    gray as three equal channels, as the preset dithers it), then its P4
    packing -> uint8[N, H, ceil(W / 8)]."""
    return pack_bits_device(mono_dither(gray[..., None].expand(gray.shape + (3,))))


def _stencil_batch_plain(plain, imgs: torch.Tensor) -> torch.Tensor:
    return _stacked([plain(x) for x in imgs], imgs.shape[1:], torch.uint8, imgs.device)


def box_blur_batch_plain(imgs: torch.Tensor) -> torch.Tensor:
    """Plain torch form of K7 box over a batch, ``box_blur_plain`` per image."""
    return _stencil_batch_plain(box_blur_plain, imgs)


def sharpen_batch_plain(imgs: torch.Tensor) -> torch.Tensor:
    """Plain torch form of K7 sharpen over a batch, ``sharpen_plain`` per image."""
    return _stencil_batch_plain(sharpen_plain, imgs)


def sobel_batch_plain(imgs: torch.Tensor) -> torch.Tensor:
    """Plain torch form of K7 Sobel over a batch, ``sobel_plain`` per image."""
    return _stencil_batch_plain(sobel_plain, imgs)


# ---------------------------------------------------------------------------
# Wrappers: the plain version on a CPU tensor, the kernel on a CUDA tensor.
# ---------------------------------------------------------------------------


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise TypeError(f"{name}: unsupported device {t.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _tiles_limit(h: int, w: int, n: int = 1) -> str | None:
    tiles = n * -(-w // _TILE_W) * -(-h // _TILE_H)
    return f"{tiles} tiles do not fit a C int" if tiles > _build.INT_MAX else None


def batch_limit(n: int) -> str | None:
    """Why a batched K3, K4, K7 or K10 launch cannot take ``n`` images, or None:
    the image is a grid axis of at most ``MAX_BATCH``."""
    return f"{n} images exceed the grid's {MAX_BATCH}" if n > MAX_BATCH else None


def gray_gauss_limit(h: int, w: int, n: int = 1) -> str | None:
    """Why K2 or K6 cannot take ``n`` images of uint8[h, w, 3] in one
    launch, or None: their C entries take H and W as ints (3 W bytes a row)
    and count the tiles of all ``n`` images in an int. Offsets into the
    images are 64-bit, so their size is no limit."""
    return _build.int_limit(h, 3 * w) or _tiles_limit(h, w, n)


def gaussian_blur_limit(h: int, w: int) -> str | None:
    """Why K5 cannot take uint8[h, w] in one launch, or None (as K2's)."""
    return _build.int_limit(h, w) or _tiles_limit(h, w)


def stencil3_limit(h: int, w: int, n: int = 1) -> str | None:
    """Why K7 cannot take ``n`` images of uint8[h, w] in one launch, or
    None: a 3-D grid of 32-row tiles takes at most ``_MAX_GRID_Y`` rows an
    image and ``MAX_BATCH`` images."""
    if h > _MAX_GRID_Y:
        return f"{h} rows exceed the grid's {_MAX_GRID_Y}"
    return _build.int_limit(h, w) or batch_limit(n)


def dither_pack_limit(h: int, w: int, n: int = 1) -> str | None:
    """Why K10 cannot take ``n`` images of uint8[h, w] in one launch, or
    None: its C entry takes H and W as ints, and the image is a grid axis of
    at most ``MAX_BATCH``."""
    return _build.int_limit(h, w) or batch_limit(n)


def _refuse(name: str, img: torch.Tensor, limit, batch: bool = False) -> None:
    """Raise ``TooLarge`` where ``limit`` refuses ``img`` (uint8[H, W, ...],
    or with ``batch`` uint8[N, H, W, ...])."""
    if batch:
        n, h, w = img.shape[:3]
        reason, what = limit(h, w, n), f"{n}x{h}x{w}"
    else:
        h, w = img.shape[:2]
        reason, what = limit(h, w), f"{h}x{w}"
    if reason:
        raise _build.TooLarge(f"{name}: {what} is too large: {reason}")


def _check_gray(name: str, img: torch.Tensor, limit, batch: bool = False) -> None:
    _require_cuda(name, img)
    if img.dtype != torch.uint8 or img.ndim != 2 + batch or not img.is_contiguous():
        raise TypeError(
            f"{name}: need a contiguous uint8[{'N, ' * batch}H, W] tensor, got "
            f"{img.dtype} {tuple(img.shape)} contiguous={img.is_contiguous()}")
    _refuse(name, img, limit, batch)


def _check_rgb(name: str, img: torch.Tensor, batch: bool = False) -> None:
    _require_cuda(name, img)
    if (img.dtype != torch.uint8 or img.ndim != 3 + batch or img.shape[-1] != 3
            or not img.is_contiguous()):
        raise TypeError(
            f"{name}: need a contiguous uint8[{'N, ' * batch}H, W, 3] tensor, got "
            f"{img.dtype} {tuple(img.shape)} contiguous={img.is_contiguous()}")
    _refuse(name, img, gray_gauss_limit, batch)


def _gray_gauss(wrapper, entry: str, img: torch.Tensor, histogram: bool, batch: bool):
    """The body of K2's and K6's wrappers on a CUDA tensor: uint8[(N,) H, W,
    3] through the C entry point ``entry`` (counted on ``wrapper``), with
    ``histogram`` each image's int32[256] histogram too."""
    _check_rgb(wrapper.__name__, img, batch)
    dims = tuple(img.shape[:-1])  # ([N,] H, W), the C entry's dimensions
    if histogram:
        _check_count(dims[-2] * dims[-1])  # each int32 histogram, as the plain version's
    out = torch.empty(dims, dtype=torch.uint8, device=img.device)
    hist = None
    if histogram:
        hist = torch.zeros(dims[:-2] + (256,), dtype=torch.int32, device=img.device)
    if out.numel():
        status = getattr(_build.library(), entry)(
            img.data_ptr(), out.data_ptr(), *(() if hist is None else (hist.data_ptr(),)), *dims,
            img.device.index, _stream(img))
        _build.check(status, entry)
        wrapper.launches += 1
    return (out, hist) if histogram else out


def gray_gauss_hist(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8[H, W, 3] -> (uint8[H, W], int32[256]): K2 on CUDA, plain on CPU."""
    if img.device.type == "cpu":
        return gray_gauss_hist_plain(img)
    return _gray_gauss(gray_gauss_hist, "ipt_gray_gauss_hist", img, True, False)


def gray_gauss(img: torch.Tensor) -> torch.Tensor:
    """uint8[H, W, 3] -> uint8[H, W], gray fused into the 5x5 binomial: K6 on
    CUDA, plain on CPU."""
    if img.device.type == "cpu":
        return gray_gauss_plain(img)
    return _gray_gauss(gray_gauss, "ipt_gray_gauss", img, False, False)


def gray_gauss_hist_batch(imgs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8[N, H, W, 3] -> (uint8[N, H, W], int32[N, 256]), each image as
    ``gray_gauss_hist``: K2 over the batch in one launch on CUDA, the plain
    batch version on CPU."""
    if imgs.device.type == "cpu":
        return gray_gauss_hist_batch_plain(imgs)
    return _gray_gauss(gray_gauss_hist_batch, "ipt_gray_gauss_hist_batch", imgs, True, True)


def gray_gauss_batch(imgs: torch.Tensor) -> torch.Tensor:
    """uint8[N, H, W, 3] -> uint8[N, H, W], each image as ``gray_gauss``:
    K6 over the batch in one launch on CUDA, the plain batch version on CPU."""
    if imgs.device.type == "cpu":
        return gray_gauss_batch_plain(imgs)
    return _gray_gauss(gray_gauss_batch, "ipt_gray_gauss_batch", imgs, False, True)


@graphs.device_table(maxsize=64)
def _chain_table(chain: tuple, device: torch.device) -> torch.Tensor:
    """K8's uint8[256] table on ``device``: the chain's plain arithmetic on
    every gray value, made once per (chain, device)."""
    gray = torch.arange(256, dtype=torch.int32)
    return _chain_plain(gray, chain).to(torch.uint8).to(device)


def fused_elementwise(img: torch.Tensor, chain=()) -> torch.Tensor:
    """uint8[..., 3] -> uint8[...]: gray, then the static ``chain`` of
    ("invert" | "brightness" | "contrast" | "threshold", arg) in order. K8
    on CUDA (contiguous input), plain on CPU."""
    chain = tuple((op, arg) for op, arg in chain)
    if img.device.type == "cpu":
        return fused_elementwise_plain(img, chain)
    _require_cuda("fused_elementwise", img)
    if (img.dtype != torch.uint8 or img.ndim < 1 or img.shape[-1] != 3
            or not img.is_contiguous()):
        raise TypeError(
            f"fused_elementwise: need a contiguous uint8[..., 3] tensor, got "
            f"{img.dtype} {tuple(img.shape)} contiguous={img.is_contiguous()}")
    table = _chain_table(chain, img.device) if chain else None  # raises on unknown ops
    out = torch.empty(img.shape[:-1], dtype=torch.uint8, device=img.device)
    if out.numel():
        status = _build.library().ipt_fused_elementwise(
            img.data_ptr(), out.data_ptr(), None if table is None else table.data_ptr(),
            out.numel(), img.device.index, _stream(img))
        _build.check(status, "ipt_fused_elementwise")
        fused_elementwise.launches += 1
    return out


def _check_values(name: str, values: torch.Tensor) -> None:
    _require_cuda(name, values)
    if values.dtype != torch.uint8 or not values.is_contiguous():
        raise TypeError(
            f"{name}: need contiguous uint8 values, got {values.dtype} "
            f"contiguous={values.is_contiguous()}")


def lut_apply(values: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """uint8 values through a uint8[256] LUT: K3 on CUDA, plain on CPU."""
    if values.device.type == "cpu":
        return lut_apply_plain(values, lut)
    _check_values("lut_apply", values)
    if (lut.device != values.device or lut.dtype != torch.uint8
            or tuple(lut.shape) != (256,) or not lut.is_contiguous()):
        raise TypeError(
            f"lut_apply: need a contiguous uint8[256] LUT on {values.device}, got "
            f"{lut.dtype} {tuple(lut.shape)} on {lut.device}")
    out = torch.empty_like(values)
    if out.numel():
        status = _build.library().ipt_lut_apply(
            values.data_ptr(), out.data_ptr(), lut.data_ptr(), values.numel(),
            values.device.index, _stream(values))
        _build.check(status, "ipt_lut_apply")
        lut_apply.launches += 1
    return out


def lut_apply_batch(values: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Image i of uint8[N, ...] through row i of uint8[N, 256], each as
    ``lut_apply``: K3 over the batch in one launch on CUDA, the plain batch
    version on CPU."""
    if values.device.type == "cpu":
        return lut_apply_batch_plain(values, luts)
    _check_values("lut_apply_batch", values)
    n = values.shape[0] if values.ndim else 0
    if (values.ndim < 1 or luts.device != values.device or luts.dtype != torch.uint8
            or tuple(luts.shape) != (n, 256) or not luts.is_contiguous()):
        raise TypeError(
            f"lut_apply_batch: need uint8[N, ...] values and a contiguous uint8[N, 256] "
            f"on {values.device}, got {tuple(values.shape)} and {luts.dtype} "
            f"{tuple(luts.shape)} on {luts.device}")
    reason = batch_limit(n)
    if reason:
        raise _build.TooLarge(f"lut_apply_batch: {tuple(values.shape)} is too large: {reason}")
    out = torch.empty_like(values)
    if out.numel():
        status = _build.library().ipt_lut_apply_batch(
            values.data_ptr(), out.data_ptr(), luts.data_ptr(), n, values.numel() // n,
            values.device.index, _stream(values))
        _build.check(status, "ipt_lut_apply_batch")
        lut_apply_batch.launches += 1
    return out


@functools.cache
def _bayer_words() -> tuple:
    """K10's thresholds: word k holds ``BAYER_THRESHOLD_INT[k, x]`` in its byte x."""
    return tuple(sum(int(t) << 8 * x for x, t in enumerate(row))
                 for row in _exact.BAYER_THRESHOLD_INT)


def dither_pack_batch(gray: torch.Tensor) -> torch.Tensor:
    """print_ready's dither and P4 packing of each image of an equalized
    gray uint8[N, H, W] -> uint8[N, H, ceil(W / 8)], MSB-first, pad bits 0:
    K10 in one launch over the batch on CUDA (it writes every output byte),
    the plain version on CPU. The span ``dither.p4``."""
    with span("dither.p4"):
        if gray.device.type == "cpu":
            return dither_pack_batch_plain(gray)
        _check_gray("dither_pack_batch", gray, dither_pack_limit, batch=True)
        n, h, w = gray.shape
        out = torch.empty((n, h, -(-w // 8)), dtype=torch.uint8, device=gray.device)
        if out.numel():
            status = _build.library().ipt_dither_pack_batch(
                gray.data_ptr(), out.data_ptr(), n, h, w, *_bayer_words(), gray.device.index,
                _stream(gray))
            _build.check(status, "ipt_dither_pack_batch")
            dither_pack_batch.launches += 1
        return out


def _arrival_words(n: int, device: torch.device) -> torch.Tensor:
    """Zeroed arrival words for ``n`` images of a K4 launch, made by the
    caller: under capture from the graph's pool, zeroed by a node of the graph
    just before K4's (at every replay, because the block goes back to the
    pool when the wrapper returns and later nodes may reuse it)."""
    return torch.zeros(n * _build.library().ipt_histogram_arrival_words(), dtype=torch.int64,
                       device=device)


def histogram_batch(values: torch.Tensor) -> torch.Tensor:
    """uint8[N, ...] -> int32[N, 256], each image's bin counts as
    ``histogram`` gives them: K4 over the batch in one launch on CUDA, the
    plain batch version on CPU. Exact below 2^31 elements an image; raises
    ValueError at or above."""
    if values.device.type == "cpu":
        return histogram_batch_plain(values)
    _check_values("histogram_batch", values)
    if values.ndim < 1:
        raise TypeError(f"histogram_batch: need uint8[N, ...] values, got {tuple(values.shape)}")
    n = values.shape[0]
    per_image = values[0].numel() if n else 0
    _check_count(per_image)
    reason = batch_limit(n)
    if reason:
        raise _build.TooLarge(f"histogram_batch: {tuple(values.shape)} is too large: {reason}")
    if not values.numel():
        return torch.zeros((n, 256), dtype=torch.int32, device=values.device)
    hist = torch.empty((n, 256), dtype=torch.int32, device=values.device)  # K4 stores every bin
    status = _build.library().ipt_histogram_batch(
        values.data_ptr(), hist.data_ptr(), n, per_image, values.device.index, _stream(values),
        _arrival_words(n, values.device).data_ptr())
    _build.check(status, "ipt_histogram_batch")
    histogram_batch.launches += 1
    return hist


def histogram(values: torch.Tensor) -> torch.Tensor:
    """uint8[...] -> int32[256] bin counts: K4 on CUDA, plain on CPU.
    Exact below 2^31 elements; raises ValueError at or above."""
    if values.device.type == "cpu":
        return histogram_plain(values)
    _check_values("histogram", values)
    _check_count(values.numel())
    if not values.numel():
        return torch.zeros(256, dtype=torch.int32, device=values.device)
    hist = torch.empty(256, dtype=torch.int32, device=values.device)  # K4 stores every bin
    words = None  # eager: the stream's own arrival words, made by the C at first use
    if torch.cuda.is_current_stream_capturing():
        # A capture may not allocate in the C, and a graph may run beside any
        # stream or other graph: it gets words of its own from its pool.
        words = _arrival_words(1, values.device)
    status = _build.library().ipt_histogram(
        values.data_ptr(), hist.data_ptr(), values.numel(),
        values.device.index, _stream(values), None if words is None else words.data_ptr())
    _build.check(status, "ipt_histogram")
    histogram.launches += 1
    return hist


def _stencil(wrapper, entry: str, plain, img: torch.Tensor, limit=stencil3_limit,
             batch: bool = False) -> torch.Tensor:
    """The body of one stencil wrapper: ``plain`` on a CPU tensor, the C
    entry point ``entry`` on a CUDA tensor, uint8[H, W] (or with ``batch``
    uint8[N, H, W], in one launch), counted on ``wrapper``. ``limit``: the
    launch's limit function (K7's by default)."""
    if img.device.type == "cpu":
        return plain(img)
    _check_gray(wrapper.__name__, img, limit, batch)
    out = torch.empty_like(img)
    if out.numel():
        status = getattr(_build.library(), entry)(
            img.data_ptr(), out.data_ptr(), *img.shape, img.device.index, _stream(img))
        _build.check(status, entry)
        wrapper.launches += 1
    return out


def box_blur_batch(imgs: torch.Tensor) -> torch.Tensor:
    """3x3 box of each image of uint8[N, H, W]: K7 over the batch on CUDA."""
    return _stencil(box_blur_batch, "ipt_box_blur_batch", box_blur_batch_plain, imgs,
                    batch=True)


def sharpen_batch(imgs: torch.Tensor) -> torch.Tensor:
    """3x3 sharpen of each image of uint8[N, H, W]: K7 over the batch on CUDA."""
    return _stencil(sharpen_batch, "ipt_sharpen_batch", sharpen_batch_plain, imgs,
                    batch=True)


def sobel_batch(imgs: torch.Tensor) -> torch.Tensor:
    """Sobel magnitude of each image of uint8[N, H, W]: K7 over the batch on CUDA."""
    return _stencil(sobel_batch, "ipt_sobel_batch", sobel_batch_plain, imgs,
                    batch=True)


def gaussian_blur(img: torch.Tensor) -> torch.Tensor:
    """5x5 binomial, uint8[H, W] -> uint8[H, W]: K5 on CUDA, plain on CPU."""
    return _stencil(gaussian_blur, "ipt_gaussian_blur", gaussian_blur_plain, img,
                    limit=gaussian_blur_limit)  # a 1-D grid of resident blocks


def box_blur(img: torch.Tensor) -> torch.Tensor:
    """3x3 box, uint8[H, W] -> uint8[H, W]: K7 on CUDA, plain on CPU."""
    return _stencil(box_blur, "ipt_box_blur", box_blur_plain, img)


def sharpen(img: torch.Tensor) -> torch.Tensor:
    """3x3 sharpen, uint8[H, W] -> uint8[H, W]: K7 on CUDA, plain on CPU."""
    return _stencil(sharpen, "ipt_sharpen", sharpen_plain, img)


def sobel(img: torch.Tensor) -> torch.Tensor:
    """Sobel magnitude, uint8[H, W] -> uint8[H, W]: K7 on CUDA, plain on CPU."""
    return _stencil(sobel, "ipt_sobel", sobel_plain, img)


BATCH_WRAPPERS = (gray_gauss_hist_batch, gray_gauss_batch, lut_apply_batch, histogram_batch,
                  box_blur_batch, sharpen_batch, sobel_batch, dither_pack_batch)

for _wrapper in (gray_gauss_hist, gray_gauss, fused_elementwise, lut_apply, histogram,
                 gaussian_blur, box_blur, sharpen, sobel) + BATCH_WRAPPERS:
    _wrapper.launches = 0
del _wrapper
