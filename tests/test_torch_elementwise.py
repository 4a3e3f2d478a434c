"""K8 (gray + a static pointwise chain) of the port against the JAX package, on the CPU.

``core.fused_elementwise_plain`` is held to ``pallas_core.fused_elementwise_pallas``
in interpret mode (as tests/test_pallas_kernels.py runs it, ``block_rows=8``)
on the planes of the same image, and the port's ``ops.grayscale`` to the JAX
``ops.grayscale``. Tolerance: none. The table that the CUDA kernel looks up
(``core._chain_table``) is held to the plain chain on every gray value, so
the kernel's design is checked here too; the kernel itself is compared with
the plain version on the card (tests/test_torch_kernels_cuda.py).

Contrast is f32 arithmetic, ``(v - 128) * f + 128`` then ``floor(x + 0.5)``.
The port rounds after each of the three operations, as the Pallas source is
written. XLA on the CPU contracts the multiply and add into one fused
multiply-add, so JAX's interpret mode rounds once there. At the factors
0.5, 1.37, 1.5 and 2.0 the two agree on all 256 gray values (byte-equal,
below). At some other factors they do not: at 1.1 and 2.7 a few gray values
differ by exactly 1, where the single rounding of the fused form lands on
the other side of a .5 (``test_contrast_where_xla_fuses_the_multiply_add``
pins this at most 1). The ±1 budget against the f64-LUT
``ops.color.contrast`` is the Pallas kernel's documented contract.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu import ops as jax_ops
from imageprocessingtools_tpu.kernels import pallas_core as pk
from imageprocessingtools_tpu.ops import color as jax_color
from imageprocessingtools_tpu_torch import ops
from imageprocessingtools_tpu_torch.kernels import core
from tests.conftest import make_gradient, make_image

# The chain of tests/test_pallas_kernels.py::test_fused_elementwise_chain,
# and the full chain that profile_device.py and chip_smoke.py time.
PALLAS_TEST_CHAIN = (("invert", 0), ("brightness", 30), ("threshold", 128))
FULL_CHAIN = (("invert", 0), ("brightness", 30), ("contrast", 1.5), ("threshold", 128))
SINGLE_OPS = (
    ("invert", 0), ("brightness", 30), ("brightness", -40), ("brightness", 300),
    ("contrast", 1.5), ("contrast", 0.5), ("threshold", 128), ("threshold", 0),
    ("threshold", 256),
)
CHAINS = [(), PALLAS_TEST_CHAIN, FULL_CHAIN] + [(op,) for op in SINGLE_OPS]
CONTRAST_FACTORS = (0.5, 1.37, 1.5, 2.0)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPT_DEVICE", "cpu")


def _all_grays() -> np.ndarray:
    """uint8[16, 128, 3] whose gray values cover 0..255: half r=g=b=v, half noise."""
    v = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(8, 128)
    flat = np.stack([v, v, v], axis=-1)
    return np.concatenate([flat, make_image(8, 128, seed=21)], axis=0)


def _gray(img: np.ndarray) -> np.ndarray:
    return (img.astype(np.int32).sum(-1) // 3).astype(np.uint8)


def _pallas(img: np.ndarray, chain) -> np.ndarray:
    planes = (img[:, :, 0], img[:, :, 1], img[:, :, 2])
    return np.asarray(pk.fused_elementwise_pallas(planes, chain=chain, block_rows=8))


@pytest.mark.parametrize("chain", CHAINS, ids=str)
def test_fused_elementwise_plain_matches_pallas(chain):
    img = make_image(16, 128, seed=22)
    out = core.fused_elementwise_plain(torch.from_numpy(img), chain)
    assert out.dtype == torch.uint8 and tuple(out.shape) == (16, 128)
    np.testing.assert_array_equal(out.numpy(), _pallas(img, chain))


@pytest.mark.parametrize("factor", CONTRAST_FACTORS)
def test_contrast_matches_pallas_on_every_gray_value(factor):
    img = _all_grays()
    chain = (("contrast", factor),)
    out = core.fused_elementwise_plain(torch.from_numpy(img), chain)
    np.testing.assert_array_equal(out.numpy(), _pallas(img, chain))
    lut = np.asarray(jax_color._contrast_lut(factor))  # the f64-LUT op: within 1
    assert np.abs(out.numpy().astype(int) - lut[_gray(img)]).max() <= 1


@pytest.mark.parametrize("factor", [1.1, 2.7])
def test_contrast_where_xla_fuses_the_multiply_add(factor):
    img = _all_grays()
    chain = (("contrast", factor),)
    out = core.fused_elementwise_plain(torch.from_numpy(img), chain).numpy()
    diff = np.abs(out.astype(int) - _pallas(img, chain).astype(int))
    assert diff.max() <= 1
    # The port's value is the three separately rounded f32 operations.
    x = _gray(img).astype(np.float32)
    f32 = np.float32
    exp = np.floor((x - f32(128)) * f32(factor) + f32(128) + f32(0.5))
    np.testing.assert_array_equal(out, np.clip(exp, 0, 255).astype(np.uint8))


@pytest.mark.parametrize("chain", CHAINS + [(("contrast", f),) for f in CONTRAST_FACTORS],
                         ids=str)
def test_kernel_table_is_the_plain_chain(chain):
    img = torch.from_numpy(_all_grays())
    exp = core.fused_elementwise_plain(img, chain)
    if chain:
        table = core._chain_table(chain, torch.device("cpu"))
        assert table.dtype == torch.uint8 and tuple(table.shape) == (256,)
        assert torch.equal(table[core.grayscale_plain(img).long()], exp)
    before = core.fused_elementwise.launches
    assert torch.equal(core.fused_elementwise(img, list(chain)), exp)
    assert core.fused_elementwise.launches == before  # CPU: no kernel


def test_unknown_op_raises():
    img = torch.from_numpy(make_image(2, 3, seed=23))
    with pytest.raises(ValueError, match="unknown op"):
        core.fused_elementwise(img, (("solarize", 1),))
    with pytest.raises(ValueError, match="unknown op"):
        core._chain_table((("solarize", 1),), torch.device("cpu"))


@pytest.mark.parametrize("kind", ["noise", "gradient", "view", "batch"])
@pytest.mark.parametrize("shape", [(1, 1), (5, 17), (16, 128), (37, 53)])
def test_grayscale_matches_jax(shape, kind):
    img = make_image(*shape, seed=24) if kind != "gradient" else make_gradient(*shape)
    if kind == "view":
        img = make_image(shape[0], 2 * shape[1], seed=25)
        src = torch.from_numpy(img)[:, ::2]  # not contiguous
        img = np.ascontiguousarray(img[:, ::2])
    elif kind == "batch":
        img = np.stack([img, make_image(*shape, seed=26)])
        src = torch.from_numpy(img)
    else:
        src = torch.from_numpy(img)
    out = ops.grayscale(src)
    exp = np.asarray(jax_ops.grayscale(img))
    assert out.dtype == torch.uint8 and tuple(out.shape) == exp.shape
    np.testing.assert_array_equal(out.numpy(), exp)
    np.testing.assert_array_equal(core.grayscale_plain(src).numpy(), exp)
