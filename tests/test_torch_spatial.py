"""The port's row-band module (``parallel/spatial.py``) on the CPU.

Every spatial function, on meshes of 1, 2, 3, 4 and 8 bands of the CPU
device (a mesh may name a device more than once), must give the bytes of the
port's unsharded op, and the reference ops those of the golden model. The
same inputs (numpy seeds) go through the JAX package's ``spatial.py`` on its
8 virtual CPU devices: the fused pipeline and the presets edge_detect,
enhance and print_ready must be equal to it, and resize and rotation within
that package's ``float_stage_budget`` of its float32 paths (the port's are
f64 in the C's order and held equal to the golden model instead).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from imageprocessingtools_tpu.golden import model as golden
from imageprocessingtools_tpu.ops.common import float_stage_budget as jax_budget
from imageprocessingtools_tpu.parallel import spatial as jax_spatial
import imageprocessingtools_tpu_torch as port
from imageprocessingtools_tpu_torch.kernels import fused
from imageprocessingtools_tpu_torch.kernels import rotate as k1
from imageprocessingtools_tpu_torch.models import PRESETS
from imageprocessingtools_tpu_torch.parallel import spatial
from imageprocessingtools_tpu_torch.parallel.spatial import Band
from imageprocessingtools_tpu_torch.pipeline import PipelineConfig, run_pipeline
from tests.conftest import make_gradient, make_image

CPU = torch.device("cpu")
BANDS = [1, 2, 3, 4, 8]
# Uneven bands, bands shorter than a halo (9 rows in 4-row granules: 4, 4,
# 1), one row, one column, a width not a multiple of 8.
SHAPES = [(1, 7), (9, 13), (37, 53), (64, 48), (6, 1)]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPT_DEVICE", "cpu")


def _mesh(n):
    return (CPU,) * n


def _img(h, w, seed=0, gray=False):
    img = make_image(h, w, seed=seed) if seed % 2 == 0 else make_gradient(h, w)
    return np.ascontiguousarray(img[:, :, 0]) if gray else img


def _jax_mesh(n=8):
    return Mesh(np.asarray(jax.devices()[:n]), ("sp",))


@pytest.mark.parametrize("height,n,granule,expected", [
    (10, 1, 4, [(0, 10)]),
    (10, 2, 4, [(0, 4), (4, 10)]),
    (10, 3, 4, [(0, 4), (4, 8), (8, 10)]),
    (10, 8, 4, [(0, 4), (4, 8), (8, 10)]),
    (1, 8, 4, [(0, 1)]),
    (100, 3, 32, [(0, 32), (32, 64), (64, 100)]),
    (2160, 4, 4, [(0, 540), (540, 1080), (1080, 1620), (1620, 2160)]),
])
def test_split_rows(height, n, granule, expected):
    assert spatial.split_rows(height, n, granule) == expected


@pytest.mark.parametrize("height", [1, 3, 4, 5, 31, 37, 100, 4409])
@pytest.mark.parametrize("n", BANDS)
@pytest.mark.parametrize("granule", [4, 32])
def test_split_rows_covers_the_image_in_granules(height, n, granule):
    bands = spatial.split_rows(height, n, granule)
    assert bands[0][0] == 0 and bands[-1][1] == height
    assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
    assert all(r0 % granule == 0 and r1 > r0 for r0, r1 in bands)
    assert len(bands) == min(n, -(-height // granule))
    sizes = [r1 - r0 for r0, r1 in bands[:-1]]
    assert not sizes or max(sizes) - min(sizes) <= granule


def test_row_window_is_a_view_within_one_band_and_joins_across_bands():
    img = torch.from_numpy(_img(10, 6))
    bands = spatial.shard_rows(img, _mesh(3))
    assert [b.row0 for b in bands] == [0, 4, 8]
    inside = spatial.row_window(bands, 5, 7, CPU)
    assert inside.data_ptr() == bands[1].data[1:].data_ptr()  # no copy
    assert torch.equal(spatial.row_window(bands, 2, 9, CPU), img[2:9])
    assert torch.equal(spatial.row_window(bands, 0, 10, CPU, cols=(2, 5)), img[:, 2:5])
    assert torch.equal(spatial.gather(bands), img)
    for lo, hi in ((3, 3), (9, 11), (-1, 2)):
        with pytest.raises(ValueError, match="do not hold rows"):
            spatial.row_window(bands, lo, hi, CPU)


@pytest.mark.parametrize("n", BANDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_pipeline_spatial_equals_the_unsharded_pipeline(n, shape):
    img = _img(*shape, seed=n)
    out = spatial.gather(port.fused_pipeline_spatial(img, _mesh(n)))
    assert torch.equal(out, fused.fused_pipeline(torch.from_numpy(img)))


@pytest.mark.parametrize("n", BANDS)
@pytest.mark.parametrize("name", sorted(PRESETS))
@pytest.mark.parametrize("shape", [(9, 13), (37, 53), (1, 7)])
def test_preset_pipeline_spatial_equals_the_unsharded_preset(n, name, shape):
    img = _img(*shape, seed=n + 1)
    exp = PRESETS[name](torch.from_numpy(img))
    out = spatial.gather(port.preset_pipeline_spatial(img, name, _mesh(n)))
    assert out.dtype == torch.uint8 and torch.equal(out, exp)


def test_preset_pipeline_spatial_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="unknown preset 'bogus'"):
        port.preset_pipeline_spatial(_img(4, 4), "bogus", _mesh(2))


@pytest.mark.parametrize("n", BANDS)
@pytest.mark.parametrize("shape,new_width", [
    ((37, 53, 3), 20),     # down, antialiased taps
    ((37, 53, 3), 100),    # up
    ((48, 64, 3), 21),     # B6: a truncated height (15)
    ((128, 50, 3), 200),   # the W pass first
    ((64, 96, 1), 48),     # gray
    ((5, 9, 3), 2),        # fewer source rows than taps
    ((1, 16, 3), 32),      # one row
])
def test_resize_width_spatial_equals_resize_width_and_golden(n, shape, new_width):
    h, w, c = shape
    img = _img(h, w, seed=n, gray=c == 1)
    out = spatial.gather(port.resize_width_spatial(img, new_width, _mesh(n)))
    assert torch.equal(out, port.resize_width(torch.from_numpy(img), new_width))
    np.testing.assert_array_equal(out.numpy(), golden.resize_width(img, new_width))


def test_resize_width_spatial_raises_the_reference_messages():
    with pytest.raises(ValueError, match="ind2store"):  # B7: height 0
        port.resize_width_spatial(_img(4, 18), 2, _mesh(2))
    with pytest.raises(ValueError, match="allocating indices"):  # B9
        port.resize_width_spatial(_img(200, 10), 999999999, _mesh(2))


@pytest.mark.parametrize("n", [2, 3, 8])
def test_resize_sub_tables_read_inside_their_windows(n):
    from imageprocessingtools_tpu_torch.ops import _exact

    plan = _exact.plan_resize(48, 64, 21)
    bands = spatial._resize_plan(48, 64, 21, _mesh(n))
    (contrib,) = [c for dim, c in plan.passes if dim == 0]
    assert [(o0, o1) for o0, o1, *_ in bands] == spatial.split_rows(plan.new_height, n)
    for o0, o1, lo, hi, idx, w in bands:
        assert idx.is_contiguous() and w.is_contiguous() and idx.dtype == torch.int32
        assert 0 <= int(idx.min()) and int(idx.max()) < hi - lo
        np.testing.assert_array_equal(idx.numpy() + lo, contrib.indices[o0:o1])
        np.testing.assert_array_equal(w.numpy(), contrib.weights[o0:o1])


@pytest.mark.parametrize("n", BANDS)
@pytest.mark.parametrize("angle", [0.0, 30.0, 90.0, 135.0, 180.0, 270.0, 359.0])
@pytest.mark.parametrize("shape,gray", [((37, 53), False), ((70, 45), True), ((1, 5), False)])
def test_rotate_spatial_equals_rotate_and_golden(n, angle, shape, gray):
    img = _img(*shape, seed=int(angle), gray=gray)
    out = spatial.gather(port.rotate_spatial(img, angle, _mesh(n)))
    assert torch.equal(out, port.rotate(torch.from_numpy(img), angle))
    np.testing.assert_array_equal(out.numpy(), golden.rotate(img, angle))


def test_rotate_spatial_bands_are_whole_tile_rows():
    img = _img(40, 300, seed=2)
    bands = port.rotate_spatial(img, 45.0, _mesh(8))
    assert all(b.row0 % k1.TILE == 0 for b in bands) and len(bands) == 8
    new_h = spatial.gather(bands).shape[0]
    assert [b.row0 for b in bands] == [r0 for r0, _ in spatial.split_rows(new_h, 8, k1.TILE)]


@pytest.mark.parametrize("angle", [30.0, 45.0, 135.0, 359.0])
@pytest.mark.parametrize("shape", [(37, 53, 3), (70, 45, 1), (100, 64, 3)])
def test_rotate_band_form_equals_the_rows_of_the_full_rotation(angle, shape):
    """K1's band form (its plain version, which the CPU runs): output rows
    [oy0, oy1) from the source window ``band_window`` gives are the full
    rotation's rows; a window one row short on either side is refused."""
    h, w, c = shape
    img = torch.from_numpy(_img(h, w, seed=int(angle), gray=c == 1))
    full = k1.rotate_plain(img, angle)
    new_h = full.shape[0]
    for oy0 in range(0, new_h, k1.TILE):
        for oy1 in sorted({min(new_h, oy0 + k1.TILE), min(new_h, oy0 + 45), new_h}):
            lo, hi = k1.band_window(h, w, angle, oy0, oy1)
            band = k1.rotate_bicubic(img[lo:hi].contiguous(), angle, h, lo, (oy0, oy1))
            assert torch.equal(band, full[oy0:oy1]), (oy0, oy1)
            for a, z in ((lo + 1, hi), (lo, hi - 1)):
                if z > a:
                    with pytest.raises(ValueError, match="outside the window"):
                        k1.rotate_plain(img[a:z].contiguous(), angle, h, a, (oy0, oy1))


def test_rotate_band_form_refuses_bad_bands():
    img = torch.from_numpy(_img(37, 53))
    for kwargs in ({"out_rows": (16, 40)}, {"out_rows": (0, 10**6)},
                   {"height": 36}, {"height": 40, "src_row0": 4}):
        with pytest.raises(ValueError):
            k1.rotate_plain(img, 30.0, **kwargs)


@pytest.mark.parametrize("config", [
    PipelineConfig(mono=True, flip_v=True), PipelineConfig(mono=True, flip_h=True),
    PipelineConfig(gray=True, flip_v=True), PipelineConfig(flip_h=True),
    PipelineConfig(new_width=20, angle=30.0, gray=True, flip_h=True),
    PipelineConfig(new_width=80, angle=135.0, mono=True, flip_v=True),
    PipelineConfig(angle=270.0, mono=True), PipelineConfig(angle=90.0, flip_v=True),
], ids=str)
@pytest.mark.parametrize("n", BANDS)
def test_run_pipeline_spatial_equals_run_pipeline(config, n):
    img = _img(37, 53, seed=n)
    out = spatial.gather(spatial.run_pipeline_spatial(img, config, _mesh(n)))
    exp, _ = run_pipeline(img, config)
    assert torch.equal(out, exp)


def test_run_pipeline_spatial_refuses_no_op():
    with pytest.raises(ValueError, match="no data to write"):
        spatial.run_pipeline_spatial(_img(4, 4), PipelineConfig(), _mesh(2))


def test_dither_needs_bands_on_the_bayer_phase():
    bands = [Band(0, torch.zeros((2, 4, 3), dtype=torch.uint8)),
             Band(2, torch.zeros((2, 4, 3), dtype=torch.uint8))]
    with pytest.raises(ValueError, match="multiples of 4"):
        spatial._dither(bands)


def test_equalize_checks_the_whole_image_count():
    # One real row placed at row 2^31 / 4: a band of 4 bytes, an image of 2^31.
    bands = [Band(2**31 // 4 - 1, torch.zeros((1, 4), dtype=torch.uint8))]
    with pytest.raises(ValueError, match="2\\^31"):
        spatial._equalize(bands)


def test_histogram_counts_each_band_once(monkeypatch):
    img = _img(37, 53, seed=4)
    calls = []
    real = spatial.core.histogram

    def spy(values):
        calls.append(values.shape[0])
        return real(values)

    monkeypatch.setattr(spatial.core, "histogram", spy)
    out = spatial.gather(port.fused_pipeline_spatial(img, _mesh(3)))
    assert calls == [r1 - r0 for r0, r1 in spatial.split_rows(37, 3)]
    assert torch.equal(out, fused.fused_pipeline(torch.from_numpy(img)))


# ---------------------------------------------------------------------------
# Against the JAX package's spatial.py on its 8 virtual CPU devices.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 48), (32, 40)])
def test_fused_pipeline_spatial_matches_jax(shape):
    img = _img(*shape, seed=11)
    exp = np.asarray(jax_spatial.fused_pipeline_spatial(img, _jax_mesh(), axis_name="sp"))
    out = spatial.gather(port.fused_pipeline_spatial(img, _mesh(8)))
    np.testing.assert_array_equal(out.numpy(), exp)


@pytest.mark.parametrize("name", ["edge_detect", "enhance", "print_ready"])
def test_preset_pipeline_spatial_matches_jax(name):
    img = _img(64, 48, seed=2)
    exp = np.asarray(jax_spatial.preset_pipeline_spatial(img, name, _jax_mesh()))
    out = spatial.gather(port.preset_pipeline_spatial(img, name, _mesh(8)))
    np.testing.assert_array_equal(out.numpy(), exp)


@pytest.mark.parametrize("h,w,new_width", [(64, 96, 48), (64, 96, 192), (48, 64, 21)])
def test_resize_width_spatial_matches_jax_within_its_budget(h, w, new_width):
    img = _img(h, w, seed=3)
    exp = np.asarray(jax_spatial.resize_width_spatial(img, new_width, _jax_mesh()))
    out = spatial.gather(port.resize_width_spatial(img, new_width, _mesh(8))).numpy()
    assert out.shape == exp.shape
    assert np.abs(out.astype(np.int32) - exp).max() <= jax_budget(True, False)
    np.testing.assert_array_equal(out, golden.resize_width(img, new_width))


@pytest.mark.parametrize("angle", [30.0, 90.0, 135.0, 3.0])
def test_rotate_spatial_matches_jax_within_its_budget(angle):
    img = _img(128, 160, seed=int(angle))
    exp = np.asarray(jax_spatial.rotate_spatial(img, angle, _jax_mesh()))
    out = spatial.gather(port.rotate_spatial(img, angle, _mesh(8))).numpy()
    assert out.shape == exp.shape
    assert np.abs(out.astype(np.int32) - exp).max() <= jax_budget(False, angle % 90 != 0)
    np.testing.assert_array_equal(out, golden.rotate(img, angle))
