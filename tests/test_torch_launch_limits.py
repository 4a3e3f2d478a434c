"""The kernels' launch limits, as pure functions, at their edges.

Every kernel computes its offsets into an image in 64 bits, so an image of
2^31 bytes or more is one launch: K1, K2, K5, K6 and K7 take uint8[27000,
27000, 3] and uint8[46341, 46341]. What stays is where a C int or a grid
ends: rows and a row's bytes are C ints (``_build.int_limit``), K2, K5 and
K6 count tiles in an int, K7 and K1 take at most ``_MAX_GRID_Y`` rows in a
2-D grid, K9's grid is one-dimensional, K10 takes at most 65535 images (a
grid axis) and walks any number of rows. K2's histogram keeps the JAX
package's whole-image limit of 2^31 elements (a ValueError, as the plain
version's). The card test ``test_torch_kernels_cuda.py`` and
``chip_smoke.py`` phase 8 run the 2^31 images on the card.
"""

from __future__ import annotations

import pytest
import torch

from imageprocessingtools_tpu_torch.kernels import _build, core, rotate
from imageprocessingtools_tpu_torch.kernels import resize as k9

INT_MAX = 2**31 - 1
ROW = INT_MAX - _build.ROW_SLACK  # the longest row a launch takes, in bytes
GRID = 65535 * 32

# (limit function, arguments, refused)
CASES = {
    # K2 and K6: uint8[h, w, 3]
    "gray_gauss 27000x27000x3 (2^31 bytes and more)": (core.gray_gauss_limit, (27000, 27000), False),
    "gray_gauss rows 2^31 - 1": (core.gray_gauss_limit, (INT_MAX, 1), False),
    "gray_gauss rows 2^31": (core.gray_gauss_limit, (2**31, 1), True),
    "gray_gauss longest row": (core.gray_gauss_limit, (1, ROW // 3), False),
    "gray_gauss row past it": (core.gray_gauss_limit, (1, ROW // 3 + 1), True),
    "gray_gauss tiles 2^31 - 2^27": (core.gray_gauss_limit, (INT_MAX, 15 * 256), False),
    "gray_gauss tiles 2^31": (core.gray_gauss_limit, (INT_MAX, 16 * 256), True),
    # K5: uint8[h, w]
    "gaussian_blur 46341x46341 (2^31 bytes and more)": (core.gaussian_blur_limit, (46341, 46341), False),
    "gaussian_blur rows 2^31 - 1": (core.gaussian_blur_limit, (INT_MAX, 1), False),
    "gaussian_blur rows 2^31": (core.gaussian_blur_limit, (2**31, 1), True),
    "gaussian_blur longest row": (core.gaussian_blur_limit, (1, ROW), False),
    "gaussian_blur row past it": (core.gaussian_blur_limit, (1, ROW + 1), True),
    "gaussian_blur tiles 2^31": (core.gaussian_blur_limit, (INT_MAX, 16 * 256), True),
    # K7: uint8[h, w]
    "stencil3 46341x46341 (2^31 bytes and more)": (core.stencil3_limit, (46341, 46341), False),
    "stencil3 grid rows": (core.stencil3_limit, (GRID, 1000), False),
    "stencil3 grid rows + 1": (core.stencil3_limit, (GRID + 1, 1000), True),
    "stencil3 longest row": (core.stencil3_limit, (32, ROW), False),
    "stencil3 row past it": (core.stencil3_limit, (32, ROW + 1), True),
    # K10: (h, w, images) of uint8[N, h, w]
    "dither_pack 46341x46341 (2^31 bytes and more)": (core.dither_pack_limit, (46341, 46341), False),
    "dither_pack rows 2^31 - 1": (core.dither_pack_limit, (INT_MAX, 1), False),
    "dither_pack rows 2^31": (core.dither_pack_limit, (2**31, 1), True),
    "dither_pack longest row": (core.dither_pack_limit, (4, ROW), False),
    "dither_pack row past it": (core.dither_pack_limit, (4, ROW + 1), True),
    "dither_pack images of the grid": (core.dither_pack_limit, (2160, 3840, 65535), False),
    "dither_pack images past it": (core.dither_pack_limit, (2160, 3840, 65536), True),
    # K1: (height, width, c, new_h, new_w, output rows of the launch)
    "rotate 27000x27000x3 at 30 degrees": (
        rotate.launch_limit, (27000, 27000, 3, 36883, 36883, 36883), False),
    "rotate grid rows": (rotate.launch_limit, (GRID, 1000, 3, GRID, 1000, GRID), False),
    "rotate grid rows + 1": (rotate.launch_limit, (GRID + 1, 1000, 3, GRID + 1, 1000, GRID + 1),
                             True),
    "rotate a band of the grid's rows": (
        rotate.launch_limit, (GRID + 1, 1000, 3, GRID + 1, 1000, GRID), False),
    "rotate longest output row": (rotate.launch_limit, (10, 10, 1, 10, ROW, 10), False),
    "rotate output row past it": (rotate.launch_limit, (10, 10, 1, 10, ROW + 1, 10), True),
    "rotate source row past it": (rotate.launch_limit, (10, ROW // 3 + 1, 3, 10, 10, 10), True),
    "rotate tiles 2^31": (rotate.launch_limit, (GRID, 10, 1, GRID, 32 * 32769, GRID), True),
    # K9: (rows, cols, c, out_size, taps, dim, vec)
    "resize 27000x27000x3 -> 1920": (k9.launch_limit, (27000, 27000, 3, 1920, 29, 1, 0), False),
    # The W pass walks its (group, tile) items with one wave of blocks: rows
    # that once took 2^31 blocks of its grid are no limit.
    "resize blocks 2^31 - 1": (k9.launch_limit, (4 * INT_MAX, 1, 1, 128, 4, 1, 0), False),
    "resize blocks 2^31": (k9.launch_limit, (4 * 2**31, 1, 1, 128, 4, 1, 0), False),
    # The H pass's grid: a block a row piece of an output row.
    "resize H-pass blocks 2^31 - 1": (k9.launch_limit, (8, 1, 1, INT_MAX, 4, 0, 1), False),
    "resize H-pass blocks 2^31": (k9.launch_limit, (8, 1, 1, 2**31, 4, 0, 1), True),
    "resize taps 2^31 - 1": (k9.launch_limit, (8, 8, 1, 8, INT_MAX, 0, 8), False),
    "resize taps 2^31": (k9.launch_limit, (8, 8, 1, 8, 2**31, 0, 8), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_launch_limit(case):
    limit, args, refused = CASES[case]
    reason = limit(*args)
    if refused:
        assert isinstance(reason, str) and reason
    else:
        assert reason is None


@pytest.mark.parametrize("n, refused", [(2**31 - 1, False), (2**31, True)])
def test_histogram_count_limit(n, refused):
    """K2's and K4's whole-image limit, the JAX package's (a ValueError)."""
    if refused:
        with pytest.raises(ValueError, match="< 2\\^31"):
            core._check_count(n)
    else:
        core._check_count(n)


def _meta(*shape):
    return torch.empty(shape, dtype=torch.uint8, device="meta")


@pytest.mark.parametrize("name, img, limit", [
    ("gray_gauss_hist", _meta(27000, 27000, 3), None),
    ("gray_gauss", _meta(27000, 27000, 3), None),
    ("gaussian_blur", _meta(46341, 46341), core.gaussian_blur_limit),
    ("sobel", _meta(46341, 46341), core.stencil3_limit),
])
def test_wrapper_checks_take_2_31_bytes(name, img, limit, monkeypatch):
    """The wrappers' own checks pass an image of 2^31 bytes or more (a meta
    tensor stands in for the card's: nothing is allocated)."""
    monkeypatch.setattr(core, "_require_cuda", lambda *args: None)
    assert img.numel() >= 2**31
    if img.ndim == 3:
        core._check_rgb(name, img)
    else:
        core._check_gray(name, img, limit)


@pytest.mark.parametrize("img, limit", [
    (_meta(GRID + 1, 64), core.stencil3_limit),
    (_meta(1, ROW + 1), core.gaussian_blur_limit),
    (_meta(1, ROW // 3 + 1, 3), None),
])
def test_wrapper_checks_refuse_with_too_large(img, limit, monkeypatch):
    monkeypatch.setattr(core, "_require_cuda", lambda *args: None)
    with pytest.raises(_build.TooLarge, match="is too large: ") as err:
        if img.ndim == 3:
            core._check_rgb("gray_gauss", img)
        else:
            core._check_gray("sobel", img, limit)
    assert isinstance(err.value, MemoryError) and isinstance(err.value, RuntimeError)
