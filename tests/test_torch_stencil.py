"""The port's stencil ops (K5 and K7 plain versions on the CPU) against JAX.

The JAX side runs as its own suites run it on the CPU: ``ops.stencil`` and
the Pallas kernels in interpret mode. Tolerance: none, every comparison is
byte-identical (all stencils are integer-exact on both sides).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu.kernels import pallas_core
from imageprocessingtools_tpu.ops import stencil as jax_stencil
from imageprocessingtools_tpu_torch.kernels import core
from imageprocessingtools_tpu_torch.ops import stencil
from tests.conftest import make_gradient, make_image

_OPS = ["box_blur", "sharpen", "sobel", "gaussian_blur"]
_PALLAS = {
    "box_blur": pallas_core.box_blur_pallas,
    "sharpen": pallas_core.sharpen_pallas,
    "sobel": pallas_core.sobel_pallas,
    "gaussian_blur": pallas_core.gaussian_blur_pallas,
}
_LAUNCHES = {
    "box_blur": core.box_blur,
    "sharpen": core.sharpen,
    "sobel": core.sobel,
    "gaussian_blur": core.gaussian_blur,
}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPT_DEVICE", "cpu")


def _gray(shape, seed=0):
    return make_image(*shape, seed=seed)[:, :, 0].copy()


@pytest.mark.parametrize("shape", [(16, 40), (9, 17), (1, 5), (5, 1)])
@pytest.mark.parametrize("name", _OPS)
def test_stencil_matches_jax_and_pallas(name, shape):
    gray = _gray(shape)
    exp = np.asarray(getattr(jax_stencil, name)(gray))
    np.testing.assert_array_equal(np.asarray(_PALLAS[name](gray)), exp)
    before = _LAUNCHES[name].launches
    out = getattr(stencil, name)(torch.from_numpy(gray))
    assert _LAUNCHES[name].launches == before  # CPU: the plain version
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), exp)


@pytest.mark.parametrize("name", _OPS)
def test_stencil_extremes_and_colour_match_jax(name):
    """0/255 steps reach sharpen's clip and Sobel's largest magnitudes; an
    HWC input runs per channel, as the JAX op does."""
    edges = (_gray((12, 19), seed=3) > 127).astype(np.uint8) * 255
    rgb = make_gradient(7, 11)
    for img in (edges, rgb):
        exp = np.asarray(getattr(jax_stencil, name)(img))
        np.testing.assert_array_equal(getattr(stencil, name)(torch.from_numpy(img)).numpy(), exp)


def test_isqrt_round_matches_jax_everywhere():
    m = np.arange(0, 2**21 + 2**16, dtype=np.int32)
    exp = np.asarray(jax_stencil._isqrt_round(m))
    np.testing.assert_array_equal(stencil._isqrt_round(torch.from_numpy(m)).numpy(), exp)
    k = exp.astype(np.int64)
    assert np.all((k * k - k + 1 <= m) | (m == 0)) and np.all(m <= k * k + k)


# ---------------------------------------------------------------------------
# The packed arithmetic of the K5 kernel (csrc/gauss_tile.cuh), in numpy uint32.
# ---------------------------------------------------------------------------

_U = np.uint32


def _funnel_r16(lo, hi):
    """CUDA's __funnelshift_r(lo, hi, 16): the low word of (hi:lo) >> 16."""
    return (hi << _U(16)) | (lo >> _U(16))


def _largest_half(v: np.ndarray) -> int:
    return max(int((v & _U(0xFFFF)).max()), int((v >> _U(16)).max()))


def _packed_gaussian_blur(gray: np.ndarray) -> tuple[np.ndarray, int, int]:
    """The 5x5 binomial as the kernel computes it: 8 columns per run, two
    columns to a uint32 in 16-bit halves. Returns the output, the largest
    half of a horizontal sum and the largest half of a vertical sum."""
    h, w = gray.shape
    runs = -(-w // 8)
    ys = np.clip(np.arange(-2, h + 2), 0, h - 1)
    xs = np.clip(np.arange(-4, 8 * runs + 4), 0, w - 1)
    rows = np.ascontiguousarray(gray[ys][:, xs])            # replicate edges
    # The 16 bytes of columns x - 4 .. x + 11 of each run as four words.
    idx = 8 * np.arange(runs)[:, None] + np.arange(16)[None, :]
    words = np.ascontiguousarray(rows[:, idx]).view("<u4")  # [h + 4, runs, 4]
    e, o = words & _U(0x00FF00FF), (words >> _U(8)) & _U(0x00FF00FF)  # (c, c+2), (c+1, c+3)
    z = [_funnel_r16(e[..., 0], e[..., 1]), _funnel_r16(o[..., 0], o[..., 1]), e[..., 1],
         o[..., 1], _funnel_r16(e[..., 1], e[..., 2]), _funnel_r16(o[..., 1], o[..., 2]),
         e[..., 2], o[..., 2], _funnel_r16(e[..., 2], e[..., 3]),
         _funnel_r16(o[..., 2], o[..., 3])]
    hs = np.stack([(z[n] + z[n + 4]) + _U(4) * (z[n + 1] + z[n + 3]) + _U(6) * z[n + 2]
                   for n in (0, 1, 4, 5)], axis=-1)         # [h + 4, runs, 4]
    acc = ((hs[0:h] + hs[4:h + 4] + _U(0x00800080)) + _U(4) * (hs[1:h + 1] + hs[3:h + 3])
           + _U(6) * hs[2:h + 2])
    # Each half's upper byte: columns x, x+2 from acc[0], x+1, x+3 from acc[1], ...
    out = np.empty((h, runs, 8), np.uint8)
    for m in range(4):
        first = (m & 1) + 4 * (m >> 1)
        out[:, :, first] = (acc[..., m] >> _U(8)) & _U(0xFF)
        out[:, :, first + 2] = acc[..., m] >> _U(24)
    return out.reshape(h, 8 * runs)[:, :w], _largest_half(hs), _largest_half(acc)


def _checker(h, w):
    return ((np.add.outer(np.arange(h), np.arange(w)) % 2) * 255).astype(np.uint8)


@pytest.mark.parametrize("gray", [
    np.full((9, 21), 255, np.uint8), _checker(12, 19), _checker(1, 8), _gray((16, 40), seed=5),
    _gray((7, 3), seed=6), _gray((1, 13), seed=7), np.full((1, 1), 255, np.uint8),
], ids=["white", "checker", "checker-row", "noise", "noise-narrow", "one-row", "one-pixel"])
def test_packed_gaussian_arithmetic_matches_plain(gray):
    """The kernel adds two columns per register with no carry between the
    halves: a horizontal sum is at most 16 * 255 = 4,080 and the vertical
    sum of five of them plus the rounding 128 at most 16 * 4,080 + 128 =
    65,408 < 2^16, reached by an all-255 image."""
    out, h_max, acc_max = _packed_gaussian_blur(gray)
    np.testing.assert_array_equal(out, core.gaussian_blur_plain(torch.from_numpy(gray)).numpy())
    assert h_max <= 4080 and acc_max <= 65408
    if gray.min() == 255:
        assert (h_max, acc_max) == (4080, 65408)
