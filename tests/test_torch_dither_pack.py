"""K10's plain version and print_ready's P4 form on the CPU.

``kernels/core.py::dither_pack_batch`` (K10, ``csrc/dither_pack.cu``) dithers
and packs print_ready's equalized gray in one pass; its plain version is the
dither of the gray as three equal channels, then the P4 packing, as serving
ran them before. The kernel itself runs only on a card
(``tests/test_torch_kernels_cuda.py``). Tolerance: none, every step is an
integer compare or a bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu_torch import serving
from imageprocessingtools_tpu_torch.kernels import _build, core
from imageprocessingtools_tpu_torch.models import presets
from imageprocessingtools_tpu_torch.ops import _exact
from imageprocessingtools_tpu_torch.ops.dither import mono_dither
from imageprocessingtools_tpu_torch.ops.packing import pack_bits_device
from imageprocessingtools_tpu_torch.utils import graphs
from imageprocessingtools_tpu_torch.utils.profiling import recording


def _gray(n, h, w, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, h, w), np.uint8))


def _bits(gray: np.ndarray) -> np.ndarray:
    """1 where the pixel lies below its Bayer threshold, uint8[..., H, W]."""
    h, w = gray.shape[-2:]
    table = _exact.BAYER_THRESHOLD_INT[np.arange(h)[:, None] % 4, np.arange(w)[None, :] % 4]
    return (gray < table).astype(np.uint8)


# N in {1, 3}; W % 8 in {0, 5}, W % 16 != 0; H not a multiple of 4.
@pytest.mark.parametrize("shape", [(1, 7, 24), (3, 9, 21), (3, 6, 40), (1, 5, 13)], ids=str)
def test_dither_pack_batch_plain_is_the_dither_then_the_packing(shape):
    gray = _gray(*shape, seed=sum(shape))
    want = pack_bits_device(mono_dither(gray[..., None].expand(gray.shape + (3,))))
    got = core.dither_pack_batch(gray)  # the plain version on a CPU tensor
    assert torch.equal(core.dither_pack_batch_plain(gray), want) and torch.equal(got, want)
    assert got.shape == shape[:2] + (-(-shape[2] // 8),)
    np.testing.assert_array_equal(got.numpy(), np.packbits(_bits(gray.numpy()), axis=-1))


def test_the_gray_as_three_equal_channels_dithers_as_the_gray():
    """(g + g + g) // 3 == g: every byte value at all 16 Bayer positions
    dithers as the compare of g itself, which K10 makes."""
    gray = (torch.arange(4 * 256) // 4).to(torch.uint8)[:, None].expand(4 * 256, 4)
    got = mono_dither(gray[..., None].expand(gray.shape + (3,)))
    np.testing.assert_array_equal(got.numpy(), _bits(gray.numpy()))
    assert got.sum() == sum(int(t) for row in _exact.BAYER_THRESHOLD_INT for t in row)


def test_dither_pack_batch_is_one_span_over_the_plain_stages():
    with recording() as rec:
        core.dither_pack_batch(_gray(2, 5, 11, seed=1))
    by = {s.name: s for s in rec.spans}
    assert by["dither.mono"].parent == by["packing.p4"].parent == by["dither.p4"].seq


@pytest.mark.parametrize("form", ["one image", "batch", "fan-out element"])
def test_serving_s_print_ready_is_the_preset_then_its_packing(form):
    """Serving runs print_ready's P4 form (``presets.PRESET_P4_FORMS``): the
    same bytes as the preset followed by ``pack_bits_device``."""
    imgs = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (3, 10, 21, 3), np.uint8))
    want = pack_bits_device(presets.print_ready_batch(imgs))
    if form == "one image":
        one, _ = serving._task_fn("print_ready")
        got = torch.stack([one(img) for img in imgs])
        assert torch.equal(got[1], pack_bits_device(presets.print_ready(imgs[1])))
    elif form == "batch":
        one, _ = serving._task_fn("print_ready")
        got = graphs.batch_form_of(one)(imgs)
    else:
        one, types = serving._task_fn(("edge_detect", "print_ready"))
        got = graphs.batch_form_of(one)(imgs)[1]
        assert types[1] == serving.FILETYPE_PBM
    assert torch.equal(got, want)


def test_print_ready_s_p4_form_is_the_only_one():
    assert presets.PRESET_P4_FORMS == {"print_ready": presets.print_ready_p4}
    assert graphs.batch_form_of(presets.print_ready_p4) is presets.print_ready_p4_batch
    assert serving._task_fn("print_ready")[0].__qualname__ == "task print_ready"


def test_dither_pack_batch_refuses_more_images_than_the_grid_takes(monkeypatch):
    monkeypatch.setattr(core, "_require_cuda", lambda *args: None)
    gray = torch.empty((core.MAX_BATCH + 1, 1, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(_build.TooLarge, match="dither_pack_batch: .* is too large: "):
        core.dither_pack_batch(gray)
