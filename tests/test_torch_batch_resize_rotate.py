"""K9's and K1's batch axis on the CPU, and the ``codec`` package's names.

``kernels/resize.py::resize_pass_batch`` and ``kernels/rotate.py::
rotate_bicubic_batch`` (one launch over a batch on a card, ``jax.vmap``'s one
op over the batch) take their plain batch versions on a CPU tensor. Those are
held byte-equal, image by image, to the single-image plain versions and to
the golden model (``imageprocessingtools_tpu.golden.model``), at small
stand-ins for the main paths' geometries: 4K -> 1920 (a half), 4K -> 256
(a fifteenth), 1080p -> 3840 (a double), gray and RGB, odd widths, a batch of
one. Rotation at 30 and 135 degrees through K1's batch entry, and 0, 90, 180
and 270 as permutations. Tolerance: none, every byte equal: both versions are
f64 in the C's order. The launch limits are pure functions.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu import codec as jax_codec
from imageprocessingtools_tpu.golden import model as golden
from imageprocessingtools_tpu_torch import codec, ops
from imageprocessingtools_tpu_torch.codec import ppm
from imageprocessingtools_tpu_torch.kernels import core
from imageprocessingtools_tpu_torch.kernels import resize as k9
from imageprocessingtools_tpu_torch.kernels import rotate as k1
from imageprocessingtools_tpu_torch.utils import graphs
from tests.conftest import make_gradient, make_image


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPT_DEVICE", "cpu")


def _batch(n, h, w, gray=False):
    """uint8[n, h, w, 3] (or uint8[n, h, w]): noise and gradients in turn."""
    imgs = np.stack([make_image(h, w, seed=i) if i % 2 == 0 else make_gradient(h, w)
                     for i in range(n)])
    return imgs[..., 1].copy() if gray else imgs


def test_codec_exports_the_jax_packages_names_from_its_own_ppm():
    names = {name for name, value in vars(jax_codec).items()
             if not name.startswith("_") and not inspect.ismodule(value)}
    assert names == {"PPMError", "decode_ppm", "decode_pnm", "encode_ppm", "read_ppm",
                     "read_pnm", "write_ppm", "FILETYPE_PPM", "FILETYPE_PGM", "FILETYPE_PBM"}
    ours = {name for name, value in vars(codec).items()
            if not name.startswith("_") and not inspect.ismodule(value)}
    assert ours == names
    for name in names:
        assert getattr(codec, name) is getattr(ppm, name), name
        if not isinstance(getattr(codec, name), int):
            assert getattr(codec, name).__module__ == "imageprocessingtools_tpu_torch.codec.ppm"


# (N, H, W, new width, gray): 4K -> 1920, 4K -> 256 and 1080p -> 3840 at
# small size (the same ratios), odd widths both ways, a batch of one.
RESIZES = [(2, 18, 32, 16, False), (2, 30, 75, 5, False), (2, 9, 16, 32, False),
           (3, 18, 32, 16, True), (3, 37, 53, 16, False), (2, 37, 53, 90, True),
           (1, 9, 21, 40, False)]


@pytest.mark.parametrize("n, h, w, new_w, gray", RESIZES,
                         ids=[f"{n}x{h}x{w}{'-gray' if g else ''}-to-{nw}"
                              for n, h, w, nw, g in RESIZES])
def test_resize_pass_batch_plain_is_the_single_pass_per_image_and_the_golden_model(
        n, h, w, new_w, gray):
    imgs = _batch(n, h, w, gray)
    before = (k9.resize_pass.launches, k9.resize_pass_batch.launches)
    out, per_image = torch.from_numpy(imgs), [torch.from_numpy(x) for x in imgs]
    for dim, idx, wt in k9.device_passes(h, w, new_w, torch.device("cpu")):
        out = k9.resize_pass_batch(out, idx, wt, dim)
        per_image = [k9.resize_pass_plain(x, idx, wt, dim) for x in per_image]
        assert torch.equal(out, torch.stack(per_image))
    assert torch.equal(ops.resize_width_batch(torch.from_numpy(imgs), new_w), out)
    for i in range(n):
        np.testing.assert_array_equal(out[i].numpy(), golden.resize_width(imgs[i], new_w))
    assert (k9.resize_pass.launches, k9.resize_pass_batch.launches) == before  # plain on the CPU


@pytest.mark.parametrize("target", [(7, 33), (40, 10)])
def test_resize_batch_to_an_explicit_target_is_resize_per_image(target):
    imgs = _batch(2, 21, 30)
    got = ops.resize_batch(torch.from_numpy(imgs), *target)
    assert tuple(got.shape) == (2, *target, 3)
    for i in range(2):
        assert torch.equal(got[i], ops.resize(torch.from_numpy(imgs[i]), *target))
    with pytest.raises(ValueError):
        ops.resize_batch(torch.from_numpy(imgs), 0, 5)


@pytest.mark.parametrize("angle", [30.0, 135.0, 0.0, 90.0, 180.0, 270.0])
@pytest.mark.parametrize("n, h, w, gray", [(3, 37, 53, False), (1, 16, 40, False),
                                           (2, 9, 21, True)],
                         ids=["3x37x53", "1x16x40", "2x9x21-gray"])
def test_rotate_batch_is_rotate_per_image_and_the_golden_model(n, h, w, gray, angle):
    imgs = _batch(n, h, w, gray)
    before = (k1.rotate_bicubic.launches, k1.rotate_bicubic_batch.launches)
    got = ops.rotate_batch(torch.from_numpy(imgs), angle)
    if angle % 90:
        assert torch.equal(got, k1.rotate_batch_plain(torch.from_numpy(imgs), angle))
    for i in range(n):
        one = torch.from_numpy(imgs[i])
        assert torch.equal(got[i], ops.rotate(one, angle))
        if angle % 90:
            assert torch.equal(got[i], k1.rotate_plain(one, angle))
        np.testing.assert_array_equal(got[i].numpy(), golden.rotate(imgs[i], angle))
    assert (k1.rotate_bicubic.launches, k1.rotate_bicubic_batch.launches) == before


def test_flip_batches_flip_each_image():
    imgs = torch.from_numpy(_batch(3, 9, 21))
    for i in range(3):
        assert torch.equal(ops.flip_vertical_batch(imgs)[i], ops.flip_vertical(imgs[i]))
        assert torch.equal(ops.flip_horizontal_batch(imgs)[i], ops.flip_horizontal(imgs[i]))
        assert torch.equal(ops.flip_vertical_batch(imgs[..., 0])[i],
                           ops.flip_vertical(imgs[i, ..., 0]))


def test_plain_batch_versions_of_no_images_are_empty():
    empty = torch.empty((0, 9, 21, 3), dtype=torch.uint8)
    new_h, new_w = k1._geometry(9, 21, 30.0)[:2]
    assert tuple(k1.rotate_bicubic_batch(empty, 30.0).shape) == (0, new_h, new_w, 3)
    assert tuple(k1.rotate_bicubic_batch(empty[..., 0], 30.0).shape) == (0, new_h, new_w)
    (dim, idx, w), _ = k9.device_passes(9, 21, 8, torch.device("cpu"))
    out = k9.resize_pass_batch(empty, idx, w, dim)
    assert out.shape[0] == 0 and out.shape[dim + 1] == idx.shape[0]


@pytest.mark.parametrize("n, refused", [(1, False), (core.MAX_BATCH, False),
                                        (core.MAX_BATCH + 1, True)])
def test_the_image_grid_axis_limits_k1_and_k9(n, refused):
    assert core.MAX_BATCH == graphs.GROUP_IMAGES
    # K1: the image on grid.z; K9's H pass: the image on grid.y.
    assert (k1.launch_limit(37, 53, 3, 59, 64, 59, n) is not None) == refused
    assert (k9.launch_limit(37, 53, 3, 16, 8, 0, 1, n) is not None) == refused
    # K9's W pass takes the batch's rows as one image's: no image axis, and
    # one wave of blocks walks its (group, tile) items: no grid to outgrow.
    assert k9.launch_limit(37, 53, 3, 16, 8, 1, 0, n) is None
    assert k9.launch_limit(2**20, 53, 3, 2**16, 8, 1, 0, 2**16) is None
    assert k1.launch_limit(37, 53, 3, 59, 64, 59) is None
    assert k9.launch_limit(37, 53, 3, 16, 8, 0, 1) is None


@pytest.mark.parametrize("n, out_size, row_bytes, vec", [
    (1, 144, 768, 1),     # 4K -> 256, one image: 144 rows of 768 bytes
    (2, 144, 768, 4),     # two of them: 2 x 144 rows
    (8, 144, 768, 8),     # eight
    (1, 1080, 11520, 8),  # 4K -> 1920
])
def test_rows_vec_counts_the_blocks_of_the_whole_batch(n, out_size, row_bytes, vec):
    assert k9.rows_vec(n * out_size, row_bytes, 132) == vec
