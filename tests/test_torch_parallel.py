"""The port's batch module (``parallel/batch.py``) on the CPU.

The same batches (numpy seeds) go through the JAX package's
``parallel.batch.batch_apply`` / ``batched_fused_pipeline`` on a mesh of
one or more of its virtual CPU devices (on the CPU the JAX side runs its
plain XLA pipeline, as its own tests do) and through the port's, on one
device or split over a mesh that names the CPU several times; split runs
must also equal the port's one-device run. Tolerance: none. Every op used here is
integer-exact, or float32 in the same operation order on both sides (the
equalization LUT).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import imageprocessingtools_tpu as ipt
from imageprocessingtools_tpu.parallel import batch as jax_batch
import imageprocessingtools_tpu_torch as port
from imageprocessingtools_tpu_torch import parallel, serving
from imageprocessingtools_tpu_torch.kernels import fused
from imageprocessingtools_tpu_torch.parallel import batch
from imageprocessingtools_tpu_torch.pipeline import PipelineConfig
from tests.conftest import make_gradient, make_image


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPT_DEVICE", "cpu")


def _one_device_mesh():
    return jax_batch.default_mesh(devices=jax.devices()[:1])


def _batch(n, h, w):
    return np.stack([make_image(h, w, seed=s) if s % 2 == 0 else make_gradient(h, w)
                     for s in range(n)])


@pytest.mark.parametrize("n,h,w", [(1, 16, 24), (4, 16, 24), (3, 37, 53), (2, 5, 130)])
def test_batched_fused_pipeline_matches_jax(n, h, w):
    imgs = _batch(n, h, w)
    exp = np.asarray(jax_batch.batched_fused_pipeline(imgs, mesh=_one_device_mesh()))
    out = parallel.batched_fused_pipeline(imgs)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    assert tuple(out.shape) == (n, h, w) == exp.shape
    np.testing.assert_array_equal(out.numpy(), exp)
    for i in range(n):  # and each image is the single-image plain pipeline's
        assert torch.equal(out[i], fused.fused_pipeline(torch.from_numpy(imgs[i])))


@pytest.mark.parametrize("name", ["grayscale", "mono_dither", "flip_horizontal", "invert"])
def test_batch_apply_matches_jax(name):
    imgs = _batch(4, 13, 17)
    exp = np.asarray(jax_batch.batch_apply(getattr(ipt, name), imgs, mesh=_one_device_mesh()))
    out = batch.batch_apply(getattr(port, name), imgs)
    np.testing.assert_array_equal(out.numpy(), exp)


def test_batch_apply_takes_a_tensor_and_a_single_image_batch():
    imgs = torch.from_numpy(_batch(1, 9, 11))
    out = batch.batch_apply(lambda im: port.rotate(im, 90.0), imgs)
    assert tuple(out.shape) == (1, 11, 9, 3)
    assert torch.equal(out[0], port.rotate(imgs[0], 90.0))


def test_batch_apply_with_a_tuple_returning_fn():
    imgs = _batch(3, 12, 16)

    def two(img):
        return port.grayscale(img), port.resize_width(img, 8)

    def jax_two(img):
        return ipt.grayscale(img), ipt.flip_vertical(img)

    gray, small = batch.batch_apply(two, imgs)
    assert tuple(gray.shape) == (3, 12, 16) and tuple(small.shape) == (3, 6, 8, 3)
    exp_gray, _ = jax_batch.batch_apply(jax_two, imgs, mesh=_one_device_mesh())
    np.testing.assert_array_equal(gray.numpy(), np.asarray(exp_gray))
    for i in range(3):
        assert torch.equal(small[i], port.resize_width(torch.from_numpy(imgs[i]), 8))


def test_batch_apply_refuses_an_empty_batch():
    with pytest.raises(ValueError, match="empty batch"):
        batch.batch_apply(port.grayscale, np.zeros((0, 4, 4, 3), dtype=np.uint8))


def test_batch_apply_runs_on_the_configured_device(monkeypatch):
    seen = []
    real = batch.get_device

    def spy():
        seen.append(real())
        return seen[-1]

    monkeypatch.setattr(batch, "get_device", spy)
    out = batch.batch_apply(port.grayscale, _batch(2, 4, 4))
    assert seen == [torch.device("cpu")] and out.device.type == "cpu"


@pytest.mark.parametrize("config", [
    PipelineConfig(gray=True), PipelineConfig(new_width=8, mono=True), "enhance",
    ("edge_detect", PipelineConfig(angle=30.0), "thumbnail"),
], ids=str)
def test_process_batch_goes_through_batch_apply_with_the_same_outputs(monkeypatch, config):
    imgs = _batch(3, 16, 24)
    calls = []
    real = serving.batch_apply

    def spy(fn, images):
        calls.append(len(images))
        return real(fn, images)

    monkeypatch.setattr(serving, "batch_apply", spy)
    out, file_type = serving.process_batch(imgs, config)
    assert calls == [3]
    one, exp_type = serving._task_fn(config)
    assert file_type == exp_type
    for i in range(3):
        exp = one(torch.from_numpy(imgs[i]))
        if isinstance(exp, tuple):
            assert all(torch.equal(out[k][i], exp[k]) for k in range(len(exp)))
        else:
            assert torch.equal(out[i], exp)


# ---------------------------------------------------------------------------
# The mesh half: a batch split over a tuple of devices (here the CPU device,
# named more than once).
# ---------------------------------------------------------------------------

CPU = torch.device("cpu")


def test_default_mesh_on_the_cpu_and_from_devices():
    assert parallel.default_mesh() == (CPU,)
    assert port.default_mesh(["cpu", torch.device("cpu")]) == (CPU, CPU)


@pytest.mark.parametrize("n_dev", [1, 2, 3])
def test_batch_apply_over_a_mesh_equals_the_one_device_run(n_dev):
    imgs = _batch(6, 13, 17)
    shards = batch.batch_apply(port.grayscale, imgs, mesh=(CPU,) * n_dev)
    assert isinstance(shards, list) and len(shards) == n_dev
    assert all(tuple(s.shape) == (6 // n_dev, 13, 17) for s in shards)
    assert torch.equal(batch.gather(shards), batch.batch_apply(port.grayscale, imgs))


def test_batch_apply_over_a_mesh_with_a_tuple_returning_fn():
    imgs = _batch(4, 12, 16)

    def two(img):
        return port.grayscale(img), port.resize_width(img, 8)

    gray, small = batch.gather(batch.batch_apply(two, imgs, mesh=(CPU, CPU)))
    exp_gray, exp_small = batch.batch_apply(two, imgs)
    assert torch.equal(gray, exp_gray) and torch.equal(small, exp_small)


def test_batch_apply_over_a_mesh_refuses_an_indivisible_batch():
    with pytest.raises(ValueError, match="not divisible"):
        batch.batch_apply(port.grayscale, _batch(5, 4, 4), mesh=(CPU, CPU))


def test_batch_apply_uploads_each_shard_once_to_its_device(monkeypatch):
    moved = []
    real = torch.Tensor.to

    def spy(self, *args, **kwargs):
        moved.append(tuple(self.shape))
        return real(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    batch.batch_apply(lambda im: im[:1], _batch(6, 5, 7), mesh=(CPU,) * 3)
    assert moved == [(2, 5, 7, 3)] * 3


@pytest.mark.parametrize("n, n_dev", [(8, 8), (8, 2)])
def test_batched_fused_pipeline_over_a_mesh_matches_jax(n, n_dev):
    imgs = _batch(n, 16, 24)
    exp = np.asarray(jax_batch.batched_fused_pipeline(
        imgs, mesh=jax_batch.default_mesh(devices=jax.devices()[:n_dev])))
    out = batch.gather(parallel.batched_fused_pipeline(imgs, mesh=(CPU,) * n_dev))
    np.testing.assert_array_equal(out.numpy(), exp)


@pytest.mark.parametrize("config", [
    PipelineConfig(gray=True), PipelineConfig(new_width=8, mono=True), "print_ready",
    ("edge_detect", PipelineConfig(angle=30.0), "thumbnail"),
], ids=str)
@pytest.mark.parametrize("n, n_dev", [(4, 2), (4, 3), (1, 3), (5, 3)])
def test_process_batch_over_a_mesh_pads_and_slices(config, n, n_dev):
    imgs = _batch(n, 16, 24)
    shards, file_type = serving.process_batch(imgs, config, mesh=(CPU,) * n_dev)
    exp, exp_type = serving.process_batch(imgs, config)
    assert file_type == exp_type
    assert sum(len(s[0] if isinstance(s, tuple) else s) for s in shards) == n
    out = serving._to_host(shards)
    exp = serving._to_host(exp)
    if isinstance(exp, tuple):
        assert len(out) == len(exp)
        for a, b in zip(out, exp):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(out, exp)


@pytest.mark.parametrize("n_files, n_dev, max_batch", [(8, 2, 256), (5, 3, 256), (9, 3, 8)])
def test_process_files_over_a_mesh_equals_the_one_device_run(tmp_path, n_files, n_dev,
                                                             max_batch):
    """The JAX package's sharded-mesh, non-divisible and tiny-remainder
    cases (tests/test_serving.py), here against the port's own one-device
    run, byte for byte."""
    from imageprocessingtools_tpu_torch.codec import ppm

    paths = []
    for i in range(n_files):
        paths.append(str(tmp_path / f"in{i}.ppm"))
        ppm.write_ppm(paths[-1], make_image(8, 16, seed=i))
    config = ("print_ready", PipelineConfig(gray=True))
    one = serving.process_files(paths, config, suffix=".one", max_batch=max_batch)
    sharded = serving.process_files(paths, config, suffix=".mesh", max_batch=max_batch,
                                    mesh=(CPU,) * n_dev)
    assert len(one) == len(sharded) == n_files
    for a_paths, b_paths in zip(one, sharded):
        for a, b in zip(a_paths, b_paths):
            assert open(a, "rb").read() == open(b, "rb").read()
