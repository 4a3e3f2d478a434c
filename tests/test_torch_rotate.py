"""The port's rotation (K1's plain version on the CPU) against the references.

- ``golden.rotate`` (the f64 model verified byte-identical to the C binary):
  byte-identical, RGB and 2-D, every tested shape and angle, dims below 4
  included. Tolerance: none.
- JAX ``rotate_blocked_pallas`` in interpret mode: outside and edge zones
  exact, interior within 1 — the JAX kernel's own budget
  (``pallas_rotate.py:588-589``), not the port's.
- JAX ``ops.rotate``: within 1, the JAX device path's budget.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu.golden import model as golden
from imageprocessingtools_tpu.ops import _exact as jax_exact
from imageprocessingtools_tpu_torch import ops
from imageprocessingtools_tpu_torch.kernels import rotate as port_rotate
from tests.conftest import SHAPES_ROT, make_gradient, make_image

ANGLES = [30, 45, 117.5, 135, 245, 333.3]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPT_DEVICE", "cpu")


def _port(img: np.ndarray, angle: float) -> np.ndarray:
    return ops.rotate(torch.from_numpy(img), angle).numpy()


@pytest.mark.parametrize("angle", ANGLES)
@pytest.mark.parametrize("shape", SHAPES_ROT + [(1, 5), (2, 8), (3, 3), (8, 2)])
def test_rotate_byte_identical_to_golden(shape, angle):
    img = make_image(*shape, seed=int(angle * 10))
    for src in (img, img[:, :, 1].copy()):
        out = _port(src, angle)
        exp = golden.rotate(src, float(angle))
        assert out.shape == exp.shape and out.dtype == np.uint8
        np.testing.assert_array_equal(out, exp)


@pytest.mark.parametrize("angle", [0, 90, 180, 270, 1, 359])
def test_rotate_permutations_and_near_axes(angle):
    img = make_gradient(13, 17)
    np.testing.assert_array_equal(_port(img, angle), golden.rotate(img, float(angle)))


def test_plain_version_is_the_cpu_path_and_launches_nothing():
    img = torch.from_numpy(make_image(16, 16))
    before = port_rotate.rotate_bicubic.launches
    out = port_rotate.rotate_bicubic(img, 30.0)
    assert port_rotate.rotate_bicubic.launches == before
    assert torch.equal(out, port_rotate.rotate_plain(img, 30.0))


def test_rotate_exact_returns_numpy():
    img = make_image(13, 17)
    out = ops.rotate_exact(img, 117.5)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, golden.rotate(img, 117.5))


@pytest.mark.parametrize("angle", [30, 245])
def test_against_jax_pallas_kernel_interpret(angle, monkeypatch):
    from imageprocessingtools_tpu.kernels import pallas_rotate

    # The JAX suite's own small-shape setting (tests/test_rotate_blocked.py).
    monkeypatch.setattr(pallas_rotate, "_TILE_G", 16)
    img = make_image(160, 200, seed=int(angle))
    jax_out = pallas_rotate.rotate_blocked_pallas(img, float(angle), interpret=True)
    assert jax_out is not None
    jax_out = np.asarray(jax_out).astype(np.int64)
    out = _port(img, angle).astype(np.int64)
    assert out.shape == jax_out.shape
    plan = jax_exact.plan_rotation(160, 200, float(angle))
    diff = np.abs(out - jax_out)
    np.testing.assert_array_equal(diff[~(plan.interior | plan.edge)], 0)
    np.testing.assert_array_equal(diff[plan.edge], 0)
    assert diff.max() <= 1


@pytest.mark.parametrize("angle", [30, 135, 333.3])
@pytest.mark.parametrize("shape", [(48, 64), (29, 7)])
def test_against_jax_ops_rotate(shape, angle):
    from imageprocessingtools_tpu.ops import geometry as jax_geometry

    img = make_image(*shape, seed=3)
    jax_out = np.asarray(jax_geometry.rotate(img, float(angle))).astype(np.int64)
    out = _port(img, angle).astype(np.int64)
    assert out.shape == jax_out.shape
    assert np.abs(out - jax_out).max() <= 1


def _zones(h, w, angle):
    """Per output pixel: floor(nX), floor(nY), rX, rY, in bounds, interior,
    from the plain version's own inverse map."""
    geometry = port_rotate._geometry(h, w, angle)
    n_x, n_y = port_rotate._inverse_map(
        geometry, torch.arange(geometry[1]), torch.arange(geometry[0]))
    r_x, r_y = torch.floor(n_x + 0.5), torch.floor(n_y + 0.5)
    in_bounds = (r_x < w) & (r_y < h) & (r_y >= 0) & (r_x >= 0)
    interior = in_bounds & (r_x > 1) & (r_y > 1) & (r_x < max(w - 2, 0)) & (r_y < max(h - 2, 0))
    return (torch.floor(n_x).long(), torch.floor(n_y).long(), r_x.long(), r_y.long(),
            in_bounds, interior)


def _per_pixel_plan(h, w, angle):
    plan, box_w, box_h = port_rotate.tile_plan(h, w, angle)
    new_h, new_w = port_rotate._geometry(h, w, angle)[:2]
    tile = port_rotate.TILE
    plan = plan.reshape(-(-new_h // tile), -(-new_w // tile), 4)
    per_pixel = plan[torch.arange(new_h) // tile][:, torch.arange(new_w) // tile]
    return per_pixel, box_w, box_h


_PLAN_CASES = [(2160 // 8, 3840 // 8, 30.0), (257, 509, 45.0), (257, 509, 0.5), (61, 97, 89.5),
               (97, 61, 179.9), (120, 80, 271.0), (80, 120, 359.5), (1, 1, 30.0), (2, 3, 45.0),
               (3, 2, 135.0), (5, 300, 10.0)] + [
    (int(h), int(w), float(a)) for h, w, a in zip(
        np.random.default_rng(4).integers(1, 200, 12), np.random.default_rng(5).integers(1, 200, 12),
        np.random.default_rng(6).uniform(0, 360, 12))]


@pytest.mark.parametrize("h,w,angle", _PLAN_CASES)
def test_tile_plan_footprint_holds_every_tap(h, w, angle):
    """Every tap of every interior pixel, and the nearest pixel of every edge
    pixel, lies in its tile's footprint, and no footprint exceeds the
    launch's box."""
    plan, box_w, box_h = _per_pixel_plan(h, w, angle)
    cls, lo_x, lo_y = plan[..., 0], plan[..., 1], plan[..., 2]
    bw, bh = plan[..., 3] & 0xFFFF, plan[..., 3] >> 16
    f_x, f_y, r_x, r_y, in_bounds, interior = _zones(h, w, angle)
    assert (cls != port_rotate.OUTSIDE)[in_bounds].all()
    taps_in = (f_x - 1 >= lo_x) & (f_x + 2 < lo_x + bw) & (f_y - 1 >= lo_y) & (f_y + 2 < lo_y + bh)
    assert taps_in[interior].all()
    nearest_in = (r_x >= lo_x) & (r_x < lo_x + bw) & (r_y >= lo_y) & (r_y < lo_y + bh)
    assert nearest_in[in_bounds & ~interior].all()
    assert (lo_x >= 0).all() and (lo_y >= 0).all()
    assert (lo_x + bw <= w).all() and (lo_y + bh <= h).all()
    assert int(bw.max()) <= box_w and int(bh.max()) <= box_h


@pytest.mark.parametrize("h,w,angle", _PLAN_CASES)
def test_tile_plan_classes_agree_with_the_plain_output(h, w, angle):
    """OUTSIDE tiles hold only zeros of rotate_plain (on a constant image,
    the only zeros are outside pixels); INTERIOR tiles only interior pixels."""
    plan, _, _ = _per_pixel_plan(h, w, angle)
    cls = plan[..., 0]
    out = port_rotate.rotate_plain(torch.full((h, w, 3), 200, dtype=torch.uint8), angle)
    assert (out[cls == port_rotate.OUTSIDE] == 0).all()
    *_, in_bounds, interior = _zones(h, w, angle)
    assert torch.equal(in_bounds, (out != 0).any(-1))
    assert interior[cls == port_rotate.INTERIOR].all()


def test_tile_plan_at_4k_has_every_class():
    for angle in (30.0, 45.0, 135.0, 0.5):
        plan, box_w, box_h = port_rotate.tile_plan(2160, 3840, angle)
        assert set(plan[:, 0].tolist()) == {
            port_rotate.OUTSIDE, port_rotate.INTERIOR, port_rotate.MIXED}
        assert box_w <= 52 and box_h <= 52  # (TILE - 1) * sqrt(2) + 7 at most
