"""The port's presets against the JAX package's, on the CPU.

Tolerance: none for ``edge_detect``, ``enhance`` and ``print_ready``, whose
stages are integer-exact (the equalization LUT is float32 in the same
operation order on both sides). ``thumbnail`` is a resize: exact in the port
(byte-equal to the golden model), float32 matrix products in the JAX package,
so against JAX it is held to that package's ``float_stage_budget(True,
False)`` (2) on every byte.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu import models as jax_models
from imageprocessingtools_tpu.golden import model as golden
from imageprocessingtools_tpu.ops.common import float_stage_budget as jax_budget
from imageprocessingtools_tpu_torch import models
from imageprocessingtools_tpu_torch.pipeline import PipelineConfig
from tests.conftest import make_gradient, make_image


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPT_DEVICE", "cpu")


@pytest.mark.parametrize("kind", ["noise", "gradient"])
@pytest.mark.parametrize("shape", [(16, 24), (24, 32)])
@pytest.mark.parametrize("name", sorted(models.PRESETS))
def test_preset_matches_jax(name, shape, kind):
    img = make_image(*shape) if kind == "noise" else make_gradient(*shape)
    exp = np.asarray(jax_models.get_preset(name)(img))
    out = models.get_preset(name)(torch.from_numpy(img))
    assert out.dtype == torch.uint8 and tuple(out.shape) == exp.shape
    if name == "thumbnail":
        diff = np.abs(out.numpy().astype(np.int32) - exp.astype(np.int32))
        assert diff.max() <= jax_budget(True, False)
        np.testing.assert_array_equal(out.numpy(), golden.resize_width(img, 256))
    else:
        np.testing.assert_array_equal(out.numpy(), exp)


def test_preset_tables_match_jax():
    assert sorted(models.PRESETS) == sorted(jax_models.PRESETS)
    assert models.PRESET_FILE_TYPES == jax_models.PRESET_FILE_TYPES
    assert sorted(models.PRESET_OUTPUT_SHAPES) == sorted(models.PRESETS)


@pytest.mark.parametrize("shape", [(16, 24), (24, 32), (5, 300), (300, 7)])
@pytest.mark.parametrize("name", sorted(models.PRESETS))
def test_preset_output_shape_matches_the_preset_and_jax(name, shape):
    """The stated shape is the preset's real output shape, and the one the
    JAX package traces for serving (``_task_unpacked_shape``)."""
    from imageprocessingtools_tpu import serving as jax_serving

    img = make_image(*shape)
    out = models.get_preset(name)(torch.from_numpy(img))
    assert models.preset_output_shape(name, *shape) == tuple(out.shape)
    assert models.preset_output_shape(name, *shape) == tuple(
        jax_serving._task_unpacked_shape(name, *shape))


def test_preset_output_shape_errors_match_jax():
    from imageprocessingtools_tpu import serving as jax_serving

    # (1, 1000): thumbnail's height truncates to 0, the reference's B7 message.
    for name, h, w in (("bogus", 8, 8), ("thumbnail", 1, 1000)):
        with pytest.raises(ValueError) as jax_err:
            jax_serving._task_unpacked_shape(name, h, w)
        with pytest.raises(ValueError) as port_err:
            models.preset_output_shape(name, h, w)
        assert str(port_err.value) == str(jax_err.value)


def test_get_preset_errors_match_jax():
    for name in ("bogus", "", "Enhance"):
        with pytest.raises(ValueError) as jax_err:
            jax_models.get_preset(name)
        with pytest.raises(ValueError) as port_err:
            models.get_preset(name)
        assert str(port_err.value) == str(jax_err.value)


def test_reference_pipeline_matches_jax():
    from imageprocessingtools_tpu.pipeline import PipelineConfig as JaxConfig

    img = make_image(13, 17)
    exp = np.asarray(jax_models.reference_pipeline(JaxConfig(angle=90.0, mono=True))(img))
    out = models.reference_pipeline(PipelineConfig(angle=90.0, mono=True))(torch.from_numpy(img))
    np.testing.assert_array_equal(out.numpy(), exp)
