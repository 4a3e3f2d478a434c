"""K2-K5 and K7: CUDA wrappers of the flagship's and the presets' kernels,
and their plain versions.

Counterpart of ``imageprocessingtools_tpu/kernels/pallas_core.py``:

- K2 ``gray_gauss_hist`` (``csrc/gray_gauss_hist.cu``) replaces
  ``gray_gauss_hist_pallas``: uint8[H, W, 3] -> (blurred gray uint8[H, W],
  its int32[256] histogram) in one pass;
- K3 ``lut_apply`` (``csrc/lut_apply.cu``) replaces ``lut_apply_pallas``:
  uint8 values through a uint8[256] LUT;
- K4 ``histogram`` (``csrc/histogram.cu``) replaces ``histogram_pallas``:
  uint8 values -> int32[256];
- K5 ``gaussian_blur`` (``csrc/stencil.cu``) replaces
  ``gaussian_blur_pallas``: the 5x5 binomial on uint8[H, W];
- K7 ``box_blur``, ``sharpen`` and ``sobel`` (``csrc/stencil.cu``, one
  template) replace ``box_blur_pallas``, ``sharpen_pallas`` and
  ``sobel_pallas`` (``_make_stencil3``): 3x3 stencils on uint8[H, W].

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA tensor. The plain versions (``*_plain``) are built from
torch ops and each other only, never from a wrapper, so on a CUDA tensor
they launch none of these kernels and stay an independent reference. The
public ops (``ops/stencil.py``, ``ops/histogram.py``) call the wrappers.

Stencil edges replicate (``np.pad`` mode "edge"); all arithmetic is int32
and integer-exact, as in ``imageprocessingtools_tpu/ops/stencil.py``.
"""

from __future__ import annotations

import torch

from imageprocessingtools_tpu_torch.kernels import _build
from imageprocessingtools_tpu_torch.ops.color import grayscale

_MAX_GRID_Y = 65535 * 32  # image rows per launch: grid.y tiles of 32 rows

_GAUSS_TAPS = (1, 4, 6, 4, 1)
_BOX = ((1, 1, 1),) * 3
_SHARPEN = ((0, -1, 0), (-1, 5, -1), (0, -1, 0))
_SOBEL_X = ((-1, 0, 1), (-2, 0, 2), (-1, 0, 1))
_SOBEL_Y = ((-1, -2, -1), (0, 0, 0), (1, 2, 1))


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


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


def _check_count(img: torch.Tensor) -> None:
    if img.numel() >= 2**31:
        # int32 bins (and the equalization CDF downstream) would wrap.
        raise ValueError("histogram requires < 2^31 total elements")


def histogram_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain torch form of K4: uint8[...] -> int32[256] bin counts."""
    _check_count(img)
    return torch.bincount(img.reshape(-1), minlength=256).to(torch.int32)


def lut_apply_plain(values: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Plain torch form of K3: a gather (values in [0, 256))."""
    return lut.to(torch.uint8)[values.long()]


def gray_gauss_hist_plain(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch form of K2: gray -> Gaussian, and the blur's histogram."""
    blurred = gaussian_blur_plain(grayscale(img))
    return blurred, histogram_plain(blurred)


# ---------------------------------------------------------------------------
# Wrappers: the plain version on a CPU tensor, the kernel on a CUDA tensor.
# ---------------------------------------------------------------------------


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise TypeError(f"{name}: unsupported device {t.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_gray(name: str, img: torch.Tensor) -> None:
    _require_cuda(name, img)
    if img.dtype != torch.uint8 or img.ndim != 2 or not img.is_contiguous():
        raise TypeError(
            f"{name}: need a contiguous uint8[H, W] tensor, got "
            f"{img.dtype} {tuple(img.shape)} contiguous={img.is_contiguous()}")
    if img.shape[0] > _MAX_GRID_Y or img.numel() >= 2**31:
        raise RuntimeError(f"{name}: {img.shape[0]}x{img.shape[1]} is too large")


def gray_gauss_hist(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8[H, W, 3] -> (uint8[H, W], int32[256]): K2 on CUDA, plain on CPU."""
    if img.device.type == "cpu":
        return gray_gauss_hist_plain(img)
    _require_cuda("gray_gauss_hist", img)
    if (img.dtype != torch.uint8 or img.ndim != 3 or img.shape[2] != 3
            or not img.is_contiguous()):
        raise TypeError(
            f"gray_gauss_hist: need a contiguous uint8[H, W, 3] tensor, got "
            f"{img.dtype} {tuple(img.shape)} contiguous={img.is_contiguous()}")
    h, w = img.shape[0], img.shape[1]
    if h > _MAX_GRID_Y or img.numel() >= 2**31:
        raise RuntimeError(f"gray_gauss_hist: {h}x{w} is too large")
    out = torch.empty((h, w), dtype=torch.uint8, device=img.device)
    hist = torch.zeros(256, dtype=torch.int32, device=img.device)
    if out.numel():
        status = _build.library().ipt_gray_gauss_hist(
            img.data_ptr(), out.data_ptr(), hist.data_ptr(), h, w,
            img.device.index, _stream(img))
        _build.check(status, "ipt_gray_gauss_hist")
        gray_gauss_hist.launches += 1
    return out, hist


def lut_apply(values: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """uint8 values through a uint8[256] LUT: K3 on CUDA, plain on CPU."""
    if values.device.type == "cpu":
        return lut_apply_plain(values, lut)
    _require_cuda("lut_apply", values)
    if values.dtype != torch.uint8 or not values.is_contiguous():
        raise TypeError(
            f"lut_apply: need contiguous uint8 values, got {values.dtype} "
            f"contiguous={values.is_contiguous()}")
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


def histogram(values: torch.Tensor) -> torch.Tensor:
    """uint8[...] -> int32[256] bin counts: K4 on CUDA, plain on CPU.
    Exact below 2^31 elements; raises ValueError at or above."""
    if values.device.type == "cpu":
        return histogram_plain(values)
    _require_cuda("histogram", values)
    if values.dtype != torch.uint8 or not values.is_contiguous():
        raise TypeError(
            f"histogram: need contiguous uint8 values, got {values.dtype} "
            f"contiguous={values.is_contiguous()}")
    _check_count(values)
    hist = torch.zeros(256, dtype=torch.int32, device=values.device)
    if values.numel():
        status = _build.library().ipt_histogram(
            values.data_ptr(), hist.data_ptr(), values.numel(),
            values.device.index, _stream(values))
        _build.check(status, "ipt_histogram")
        histogram.launches += 1
    return hist


def _stencil(wrapper, entry: str, plain, img: torch.Tensor) -> torch.Tensor:
    """The body of one stencil wrapper: ``plain`` on a CPU tensor, the C
    entry point ``entry`` on a CUDA tensor (counted on ``wrapper``)."""
    if img.device.type == "cpu":
        return plain(img)
    _check_gray(wrapper.__name__, img)
    out = torch.empty_like(img)
    if out.numel():
        status = getattr(_build.library(), entry)(
            img.data_ptr(), out.data_ptr(), img.shape[0], img.shape[1],
            img.device.index, _stream(img))
        _build.check(status, entry)
        wrapper.launches += 1
    return out


def gaussian_blur(img: torch.Tensor) -> torch.Tensor:
    """5x5 binomial, uint8[H, W] -> uint8[H, W]: K5 on CUDA, plain on CPU."""
    return _stencil(gaussian_blur, "ipt_gaussian_blur", gaussian_blur_plain, img)


def box_blur(img: torch.Tensor) -> torch.Tensor:
    """3x3 box, uint8[H, W] -> uint8[H, W]: K7 on CUDA, plain on CPU."""
    return _stencil(box_blur, "ipt_box_blur", box_blur_plain, img)


def sharpen(img: torch.Tensor) -> torch.Tensor:
    """3x3 sharpen, uint8[H, W] -> uint8[H, W]: K7 on CUDA, plain on CPU."""
    return _stencil(sharpen, "ipt_sharpen", sharpen_plain, img)


def sobel(img: torch.Tensor) -> torch.Tensor:
    """Sobel magnitude, uint8[H, W] -> uint8[H, W]: K7 on CUDA, plain on CPU."""
    return _stencil(sobel, "ipt_sobel", sobel_plain, img)


for _wrapper in (gray_gauss_hist, lut_apply, histogram, gaussian_blur, box_blur,
                 sharpen, sobel):
    _wrapper.launches = 0
del _wrapper
