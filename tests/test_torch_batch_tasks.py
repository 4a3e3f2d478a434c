"""The batch forms of ``thumbnail`` and of the reference configs against the
per-image loop, the golden model and the JAX package under ``jax.vmap``, on
the CPU.

Serving runs each task over a group of images as ``jax.jit(jax.vmap(one))``
in the JAX package (``imageprocessingtools_tpu/serving.py::
_jitted_local_vmap``); the port's counterpart is the task's batch form
(``pipeline.run_pipeline_batch``, ``models.presets.thumbnail_batch``), whose
kernels launch once over the batch on a card and take their plain batch
versions here. Each flag set and ``thumbnail`` is held:

- byte-equal to the per-image loop (``graphs.eager_batch``) and, image by
  image, to the golden model (P4 rows packed as the task packs them);
- to ``jax.jit(jax.vmap(...))`` of the JAX package's task within that
  package's ``float_stage_budget(has_resize, has_float_rotation)``: its
  resize is a float32 matrix product and its rotation under a tracer the
  float32 XLA form, while the port's are exact. P4 outputs are compared
  unpacked (bits), gray and RGB outputs as bytes.

Shapes: 37 x 53 (odd, W % 16 != 0) in a batch of three, and a batch of one.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from imageprocessingtools_tpu import serving as jax_serving
from imageprocessingtools_tpu.golden import model as golden
from imageprocessingtools_tpu.ops.common import float_stage_budget as jax_budget
from imageprocessingtools_tpu.pipeline import PipelineConfig as JaxConfig
from imageprocessingtools_tpu_torch import models, serving
from imageprocessingtools_tpu_torch.kernels import resize as k9
from imageprocessingtools_tpu_torch.kernels import rotate as k1
from imageprocessingtools_tpu_torch.pipeline import PipelineConfig, run_pipeline_batch
from imageprocessingtools_tpu_torch.utils import graphs
from tests.conftest import make_gradient, make_image

# Every reference flag alone and in combinations, and thumbnail.
TASKS = ["-w16", "-w90", "-r30", "-r135", "-r90", "-r180", "-r270", "-gray", "-mono", "-fv",
         "-fh", "-w16 -r30 -gray", "-r135 -mono -fh", "-w90 -r270 -mono -fv", "-w16 -gray -fh",
         "thumbnail"]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPT_DEVICE", "cpu")


def _config(flags: str, cls=PipelineConfig):
    kw = {}
    for f in flags.split():
        if f.startswith("-w"):
            kw["new_width"] = int(f[2:])
        elif f.startswith("-r"):
            kw["angle"] = float(f[2:])
        else:
            kw[{"-gray": "gray", "-mono": "mono", "-fv": "flip_v", "-fh": "flip_h"}[f]] = True
    return cls(**kw)


def _task(label, cls=PipelineConfig):
    return label if label == "thumbnail" else _config(label, cls)


def _batch(n, h, w):
    return np.stack([make_image(h, w, seed=i) if i % 2 == 0 else make_gradient(h, w)
                     for i in range(n)])


def _golden(img, label):
    """One image through the golden model in the reference's order, P4 rows
    packed MSB-first as the task packs them."""
    if label == "thumbnail":
        return golden.resize_width(img, models.presets.THUMBNAIL_WIDTH)
    c, out = _config(label), img
    if c.new_width is not None:
        out = golden.resize_width(out, c.new_width)
    if c.angle is not None:
        out = golden.rotate(out, c.angle)
    if c.gray:
        out = golden.grayscale(out)
    if c.mono:
        out = golden.mono_dither(out)
    if c.flip_v:
        out = golden.flip_vertical(out)
    if c.flip_h:
        out = golden.flip_horizontal(out)
    return np.packbits(out, axis=-1) if c.mono else out


@functools.cache
def _vmapped(label):
    return jax.jit(jax.vmap(jax_serving._task_fn(_task(label, JaxConfig))[0]))


@pytest.mark.parametrize("label", TASKS)
@pytest.mark.parametrize("shape", [(3, 37, 53), (1, 16, 40)], ids=["3x37x53", "1x16x40"])
def test_a_tasks_batch_form_is_the_per_image_loop_and_the_golden_model(label, shape):
    one = serving._task_fn(_task(label))[0]
    form = graphs.batch_form_of(one)
    assert form is not None
    imgs = _batch(*shape)
    before = [w.launches for w in (k9.resize_pass, k9.resize_pass_batch, k1.rotate_bicubic,
                                   k1.rotate_bicubic_batch)]
    got = form(torch.from_numpy(imgs))
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert torch.equal(got, graphs.eager_batch(one, torch.from_numpy(imgs)))
    for i in range(shape[0]):
        np.testing.assert_array_equal(got[i].numpy(), _golden(imgs[i], label))
    assert [w.launches for w in (k9.resize_pass, k9.resize_pass_batch, k1.rotate_bicubic,
                                 k1.rotate_bicubic_batch)] == before  # plain on the CPU


@pytest.mark.parametrize("label", TASKS)
def test_a_tasks_batch_form_is_within_the_budget_of_the_vmapped_jax_task(label):
    imgs = _batch(3, 37, 53)
    got = graphs.batch_form_of(serving._task_fn(_task(label))[0])(torch.from_numpy(imgs)).numpy()
    want = np.asarray(_vmapped(label)(imgs))
    assert got.shape == want.shape and want.dtype == np.uint8
    config = _task(label)
    has_resize = label == "thumbnail" or config.new_width is not None
    has_rotation = label != "thumbnail" and config.angle is not None and config.angle % 90 != 0
    if label != "thumbnail" and config.mono:  # P4 rows: compare the bits
        got, want = np.unpackbits(got, axis=-1), np.unpackbits(want, axis=-1)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max()
    assert diff <= jax_budget(has_resize, has_rotation), diff


@pytest.mark.parametrize("label", ["-r30 -gray -fv", "-w16 -mono"])
def test_a_reference_pipelines_batch_form_is_run_pipeline_batch(label):
    config, imgs = _config(label), torch.from_numpy(_batch(2, 9, 21))
    fn = models.reference_pipeline(config)
    got = graphs.batch_form_of(fn)(imgs)
    assert torch.equal(got, run_pipeline_batch(imgs, config)[0])
    assert torch.equal(got, graphs.eager_batch(fn, imgs))
    assert run_pipeline_batch(imgs, config)[1] == config.file_type


def test_run_pipeline_batch_without_an_op_raises_the_references_b2_message():
    with pytest.raises(ValueError, match="no data to write"):
        run_pipeline_batch(_batch(1, 4, 4), PipelineConfig())
