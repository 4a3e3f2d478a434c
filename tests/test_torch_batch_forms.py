"""The port's batch forms (the counterpart of ``jax.vmap``) against the JAX
package under ``jax.vmap``, on the CPU.

Under ``jax.vmap`` a Pallas kernel becomes one kernel over the batch; the
port's batched wrappers (``kernels/core.py``: K2/K6, K4, K3 and K7 with a
batch axis) take their plain batch versions on a CPU tensor, and those are
held here against ``jax.vmap`` of the Pallas kernels in interpret mode (as
the JAX suite runs them on the CPU). The flagship's mega form and the
presets' batch forms are held against ``jax.vmap`` of the JAX functions,
and ``graphs.batched`` of a function with a batch form against the
per-image loop. Shapes: odd widths and heights (W % 16 != 0, H * W % 16 !=
0), a batch of one, and constant images (the identity LUT). Tolerance:
none, every byte equal: the stages are integer-exact and the equalization
LUT is float32 in the same operation order on both sides.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from imageprocessingtools_tpu import models as jax_models
from imageprocessingtools_tpu.kernels import fused as jax_fused
from imageprocessingtools_tpu.kernels import pallas_core
from imageprocessingtools_tpu.ops.dither import mono_dither as jax_mono_dither
from imageprocessingtools_tpu.ops.histogram import _equalize_lut as jax_equalize_lut
from imageprocessingtools_tpu_torch import models, serving
from imageprocessingtools_tpu_torch.kernels import TooLarge, core, fused
from imageprocessingtools_tpu_torch.models import presets
from imageprocessingtools_tpu_torch.ops import dither, equalize_histogram
from imageprocessingtools_tpu_torch.ops.histogram import _equalize_lut, equalize_histogram_batch
from imageprocessingtools_tpu_torch.parallel import batch as parallel_batch
from imageprocessingtools_tpu_torch.pipeline import PipelineConfig
from imageprocessingtools_tpu_torch.utils import graphs
from tests.conftest import make_gradient, make_image

CPU = torch.device("cpu")
# (N, H, W): 53 and 21 are not multiples of 16, nor are 37 * 53 and 9 * 21.
SHAPES = [(3, 37, 53), (1, 16, 40), (2, 9, 21)]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPT_DEVICE", "cpu")


def _batch(n, h, w, constant=False):
    """uint8[n, h, w, 3]: noise and gradients in turn, or constant images of
    two values (every histogram one bin: the identity LUT)."""
    if constant:
        return np.stack([np.full((h, w, 3), 40 + 100 * i, dtype=np.uint8) for i in range(n)])
    return np.stack([make_image(h, w, seed=i) if i % 2 == 0 else make_gradient(h, w)
                     for i in range(n)])


def _cases():
    return [(s, False) for s in SHAPES] + [((2, 9, 21), True)]


_CASE_IDS = [f"{n}x{h}x{w}{'-constant' if c else ''}" for (n, h, w), c in _cases()]


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.device == CPU and got.dtype in (torch.uint8, torch.int32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@functools.cache
def _vmapped(name: str):
    """``jax.vmap`` of a JAX function, jitted once for the whole module."""
    fns = {
        "gray_gauss_hist": pallas_core.gray_gauss_hist_pallas,
        "gray_gauss": pallas_core.gray_gauss_pallas,
        "histogram": pallas_core.histogram_pallas,
        "lut_apply": pallas_core.lut_apply_pallas,
        "box_blur": pallas_core.box_blur_pallas,
        "sharpen": pallas_core.sharpen_pallas,
        "sobel": pallas_core.sobel_pallas,
        "mega": jax_fused.fused_pipeline_pallas_mega,
        "mono_dither": jax_mono_dither,
        **{preset: jax_models.get_preset(preset)
           for preset in ("edge_detect", "enhance", "print_ready")},
    }
    return jax.jit(jax.vmap(fns[name]))


# ---------------------------------------------------------------------------
# The batched kernels' plain versions against jax.vmap of the Pallas kernels.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape, constant", _cases(), ids=_CASE_IDS)
def test_gray_gauss_batches_match_vmapped_pallas(shape, constant):
    imgs = _batch(*shape, constant=constant)
    want_blurred, want_hist = _vmapped("gray_gauss_hist")(imgs)
    before = (core.gray_gauss_hist_batch.launches, core.gray_gauss_batch.launches)
    blurred, hist = core.gray_gauss_hist_batch(torch.from_numpy(imgs))
    _equal(blurred, want_blurred)
    _equal(hist, want_hist)
    _equal(core.gray_gauss_batch(torch.from_numpy(imgs)), _vmapped("gray_gauss")(imgs))
    assert (core.gray_gauss_hist_batch.launches,
            core.gray_gauss_batch.launches) == before  # CPU: the plain versions


@pytest.mark.parametrize("shape, constant", _cases(), ids=_CASE_IDS)
def test_histogram_and_lut_batches_match_vmapped_pallas(shape, constant):
    gray = _batch(*shape, constant=constant)[..., 1].copy()
    rng = np.random.default_rng(shape[0])
    luts = rng.integers(0, 256, size=(shape[0], 256), dtype=np.uint8)
    hist = core.histogram_batch(torch.from_numpy(gray))
    _equal(hist, _vmapped("histogram")(gray))
    for i in range(shape[0]):  # each row is that image's histogram, never the batch's
        assert int(hist[i].sum()) == shape[1] * shape[2]
    _equal(core.lut_apply_batch(torch.from_numpy(gray), torch.from_numpy(luts)),
           _vmapped("lut_apply")(gray, luts))


@pytest.mark.parametrize("op", ["box_blur", "sharpen", "sobel"])
@pytest.mark.parametrize("shape, constant", _cases(), ids=_CASE_IDS)
def test_stencil3_batches_match_vmapped_pallas(shape, constant, op):
    gray = _batch(*shape, constant=constant)[..., 2].copy()
    _equal(getattr(core, f"{op}_batch")(torch.from_numpy(gray)), _vmapped(op)(gray))


def test_equalize_lut_rows_match_vmapped_jax():
    """Rows of 2304 values: noise, values from 30 on (cdf_min past bin 0),
    seven values, one value (the identity LUT) and the two extremes."""
    n = 9 * 256
    rng = np.random.default_rng(5)
    values = [rng.integers(0, 256, n), rng.integers(30, 256, n), rng.integers(0, 7, n),
              np.full(n, 9), np.repeat([0, 255], n // 2)]
    hists = np.stack([np.bincount(v, minlength=256) for v in values]).astype(np.int32)
    want = jax.vmap(lambda h: jax_equalize_lut(h, n))(hists)
    got = _equalize_lut(torch.from_numpy(hists), n)
    _equal(got, want)
    for i in range(len(values)):  # each row as the single-image LUT
        assert torch.equal(got[i], _equalize_lut(torch.from_numpy(hists[i]), n))


@pytest.mark.parametrize("shape", [(2, 9, 21), (1, 6, 13)])
def test_mono_dither_takes_a_batch_from_the_last_axes(shape):
    imgs = _batch(*shape)
    _equal(dither.mono_dither(torch.from_numpy(imgs)), _vmapped("mono_dither")(imgs))


# ---------------------------------------------------------------------------
# The flagship and the presets in their batch forms against jax.vmap.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape, constant", [((3, 37, 53), False), ((1, 16, 40), False),
                                             ((2, 9, 21), True)],
                         ids=["3x37x53", "1x16x40", "2x9x21-constant"])
def test_mega_batch_matches_vmapped_jax(shape, constant):
    imgs = _batch(*shape, constant=constant)
    assert graphs.batch_form_of(fused.fused_pipeline_mega) is fused.fused_pipeline_mega_batch
    got = fused.fused_pipeline_mega_batch(torch.from_numpy(imgs))
    _equal(got, _vmapped("mega")(imgs))
    _equal(parallel_batch.batched_fused_pipeline(imgs), _vmapped("mega")(imgs))


@pytest.mark.parametrize("name", ["edge_detect", "enhance", "print_ready"])
@pytest.mark.parametrize("shape, constant", _cases(), ids=_CASE_IDS)
def test_preset_batch_forms_match_vmapped_jax(name, shape, constant):
    imgs = _batch(*shape, constant=constant)
    form = graphs.batch_form_of(models.get_preset(name))
    assert form is getattr(presets, f"{name}_batch")
    _equal(form(torch.from_numpy(imgs)), _vmapped(name)(imgs))


def test_equalize_histogram_batch_equalizes_each_image_alone():
    imgs = _batch(3, 37, 53)[..., 0].copy()
    got = equalize_histogram_batch(torch.from_numpy(imgs))
    for i in range(3):
        assert torch.equal(got[i], equalize_histogram(torch.from_numpy(imgs[i])))


# ---------------------------------------------------------------------------
# graphs.batched with a batch form on the CPU.
# ---------------------------------------------------------------------------

_TASKS = {"mega": None, "edge_detect": "edge_detect", "enhance": "enhance",
          "print_ready": "print_ready", "thumbnail": "thumbnail",
          "-w16 -r30 -gray": PipelineConfig(new_width=16, angle=30.0, gray=True),
          "-r135 -mono -fh": PipelineConfig(angle=135.0, mono=True, flip_h=True),
          "fanout": ("edge_detect", "thumbnail", PipelineConfig(gray=True), "print_ready")}


def _task(label):
    if label == "mega":
        return fused.fused_pipeline_mega
    return serving._task_fn(_TASKS[label])[0]


@pytest.mark.parametrize("label", list(_TASKS))
def test_batched_with_a_batch_form_equals_the_per_image_loop(label, monkeypatch):
    """G = 2 over 5 images (groups of 2, 2 and 1): every group through the
    batch form, none image by image, byte-equal to the eager per-image loop."""
    one = _task(label)
    assert graphs.batch_form_of(one) is not None
    imgs = _batch(5, 9, 21)
    want = graphs.eager_batch(one, torch.from_numpy(imgs))  # the per-image loop
    monkeypatch.setattr(graphs, "GROUP_INPUT_BYTES", 2 * imgs[0].nbytes)
    seen, form = [], graphs.batch_form_of(one)
    calls = []

    def each(fn, batch):
        calls.append(fn)
        return [fn(x) for x in batch]

    monkeypatch.setattr(graphs, "_each", each)
    monkeypatch.setattr(one, "batch_form", lambda x: seen.append(x.shape[0]) or form(x))
    got = graphs.batched(one)(imgs, CPU)
    assert seen == [2, 2, 1]
    assert len(calls) == 0  # no task and no fan-out element runs per image
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device == CPU and torch.equal(g, w)


def test_the_tasks_without_a_batch_form_keep_the_per_image_loop():
    """Every serving task and fan-out has a batch form, and so does each
    fan-out element; only the staged flagship keeps the per-image loop."""
    assert graphs.batch_form_of(models.PRESETS["thumbnail"]) is presets.thumbnail_batch
    for name in models.PRESETS:
        assert graphs.batch_form_of(models.get_preset(name)) is not None, name
        assert graphs.batch_form_of(serving._task_fn(name)[0]) is not None, name
    configs = [PipelineConfig(gray=True), PipelineConfig(new_width=8, angle=30.0, mono=True),
               PipelineConfig(angle=90.0, flip_v=True)]
    for config in configs:
        assert graphs.batch_form_of(serving._task_fn(config)[0]) is not None, config
        assert graphs.batch_form_of(models.reference_pipeline(config)) is not None, config
    fanout = ("thumbnail", PipelineConfig(mono=True), "edge_detect")
    assert graphs.batch_form_of(serving._task_fn(fanout)[0]) is not None
    assert all(graphs.batch_form_of(serving._task_fn(item)[0]) is not None for item in fanout)
    assert graphs.batch_form_of(fused.fused_pipeline_staged) is None


def test_a_preset_tasks_batch_form_packs_p4_rows():
    one, file_type = serving._task_fn("print_ready")
    imgs = _batch(2, 9, 21)
    got = graphs.batch_form_of(one)(torch.from_numpy(imgs))
    assert tuple(got.shape) == (2, 9, 3)  # ceil(21 / 8) bytes a row
    assert torch.equal(got, graphs.eager_batch(one, torch.from_numpy(imgs)))


# ---------------------------------------------------------------------------
# What a batched launch takes, and the CPU's empty batches.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h, w, n, refused", [
    (2160, 3840, 10, False), (512, 512, 341, False), (1, 1, core.MAX_BATCH, False),
    (2160, 3840, 1_100_000, True),  # 2025 tiles an image: over 2^31 - 1 in all
])
def test_gray_gauss_limit_counts_the_tiles_of_the_batch(h, w, n, refused):
    assert (core.gray_gauss_limit(h, w, n) is not None) == refused
    assert core.gray_gauss_limit(h, w) is None


@pytest.mark.parametrize("n, refused", [(1, False), (core.MAX_BATCH, False),
                                        (core.MAX_BATCH + 1, True)])
def test_the_image_grid_axis_limits_k3_k4_and_k7(n, refused):
    assert core.MAX_BATCH == 65535 == graphs.GROUP_IMAGES
    assert (core.batch_limit(n) is not None) == refused
    assert (core.stencil3_limit(32, 32, n) is not None) == refused
    assert core.stencil3_limit(65535 * 32 + 1, 1, 1) is not None  # rows, as for one image


def test_a_batched_wrapper_on_a_card_refuses_what_its_launch_cannot_take(monkeypatch):
    """The refusal is ``TooLarge`` (the C's allocation surface) and comes
    before any launch; here the CUDA checks are passed over by a meta tensor."""
    monkeypatch.setattr(core, "_require_cuda", lambda name, t: None)
    big = torch.empty((core.MAX_BATCH + 1, 4, 4), dtype=torch.uint8, device="meta")
    for wrapper in (core.sobel_batch, core.histogram_batch):
        with pytest.raises(TooLarge):
            wrapper(big)
    with pytest.raises(TooLarge):
        core.lut_apply_batch(big, torch.empty((core.MAX_BATCH + 1, 256), dtype=torch.uint8,
                                              device="meta"))


def test_plain_batch_versions_of_no_images_are_empty():
    empty_rgb = torch.empty((0, 5, 7, 3), dtype=torch.uint8)
    blurred, hist = core.gray_gauss_hist_batch(empty_rgb)
    assert tuple(blurred.shape) == (0, 5, 7) and tuple(hist.shape) == (0, 256)
    assert hist.dtype == torch.int32
    assert tuple(core.sobel_batch(torch.empty((0, 5, 7), dtype=torch.uint8)).shape) == (0, 5, 7)
    assert tuple(core.histogram_batch(torch.empty((0, 5), dtype=torch.uint8)).shape) == (0, 256)
