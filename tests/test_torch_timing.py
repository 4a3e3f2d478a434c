"""The port's device timing (``utils/timing.py``) against the JAX package's.

The cases are those of ``tests/test_timing.py``: same shape, gray stack-roll,
histogram row broadcast, shape-changing scalar reduction and the batched
stack-roll. For each, the port's ``feedback`` over ``n`` steps must give the
bytes that ``tests/test_timing.py::_replay`` gives with the JAX function's
own feedback branch (copied below from
``imageprocessingtools_tpu/utils/timing.py::device_loop_rate``), and
``device_loop_rate`` on a CPU tensor must return a finite positive float.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from imageprocessingtools_tpu_torch.utils import device_loop_rate, dispatch_time, timing
from tests.test_timing import _replay

RNG = np.random.default_rng(11)
IMG = RNG.integers(0, 256, (16, 24, 3), dtype=np.uint8)
IMG2D = RNG.integers(0, 256, (8, 24), dtype=np.uint8)
IMGS = RNG.integers(0, 256, (2, 16, 24, 3), dtype=np.uint8)


def _jax_feedback(out, carry, shape):
    """The JAX function's loop body after ``out = body(carry)``."""
    need = int(np.prod(shape))
    if out.ndim == 2 and len(shape) == 3 and out.shape == shape[:2] and shape[2] == 3:
        out = out.astype(jnp.uint8)
        return jnp.stack([out, jnp.roll(out, 1, axis=0), jnp.roll(out, 7, axis=1)], axis=-1)
    if out.ndim == 3 and len(shape) == 4 and out.shape == shape[:3] and shape[3] == 3:
        out = out.astype(jnp.uint8)
        return jnp.stack([out, jnp.roll(out, 1, axis=1), jnp.roll(out, 7, axis=2)], axis=-1)
    if out.ndim == 1 and len(shape) == 2 and shape[1] % out.shape[0] == 0:
        row = jnp.tile(out.astype(jnp.uint8), shape[1] // out.shape[0])
        return jnp.broadcast_to(row[None, :], shape)
    if out.ndim == 3 and len(shape) == 3 and out.shape != shape:
        return carry ^ jnp.sum(out.astype(jnp.int32)).astype(jnp.uint8)
    flat = jnp.ravel(out.astype(jnp.uint8))
    reps = -(-need // flat.shape[0])
    return jnp.tile(flat, reps)[:need].reshape(shape)


def _gray_jax(x):
    return (x.astype(jnp.int32).sum(-1) // 3).astype(jnp.uint8)


def _gray_torch(x):
    return (x.to(torch.int32).sum(-1) // 3).to(torch.uint8)


# name -> (input, JAX body, port body)
CASES = {
    "same_shape": (IMG, lambda x: 255 - x, lambda x: 255 - x),
    "gray_stack_roll": (IMG, _gray_jax, _gray_torch),
    "hist_row_broadcast": (
        IMG2D,
        lambda x: jnp.bincount(jnp.ravel(x).astype(jnp.int32), length=256).astype(jnp.uint8)[:24],
        lambda x: torch.bincount(x.reshape(-1).long(), minlength=256).to(torch.uint8)[:24]),
    "shape_changing_scalar_reduction": (IMG, lambda x: x[::2, ::2, :], lambda x: x[::2, ::2, :]),
    "batched_stack_roll": (IMGS, _gray_jax, _gray_torch),
    # Rolls longer than the axis (1 row of 1, 7 columns of 4) wrap around.
    "stack_roll_short_axes": (IMG[:1, :4], _gray_jax, _gray_torch),
    "batched_stack_roll_short_axes": (IMGS[:, :3, :5], _gray_jax, _gray_torch),
    # No branch of its own: a shape-changing output of another rank is
    # ravelled and tiled.
    "ravel_and_tile": (IMG, lambda x: x[:5, :7, 0], lambda x: x[:5, :7, 0]),
}


def _port_replay(body, img: np.ndarray, n: int) -> np.ndarray:
    carry = torch.from_numpy(img)
    for _ in range(n):
        carry = timing.feedback(body(carry), carry, img.shape)
    return carry.numpy()


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_feedback_replays_the_jax_branch(case, n):
    img, jax_body, port_body = CASES[case]
    expect = _replay(jax_body, lambda out, c: _jax_feedback(out, c, img.shape), img, n)
    got = _port_replay(port_body, img, n)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, expect)


def test_shape_changing_carry_matches_the_jax_fori_loop():
    """The carry of ``test_timing.py::test_shape_changing_scalar_reduction_semantics``'s
    ``lax.fori_loop``, built here as it builds it, against the port's loop."""
    def loop_body(_, carry):
        out = carry[::2, ::2, :]
        s = jnp.sum(out.astype(jnp.int32)).astype(jnp.uint8)
        return carry ^ s

    expect = np.asarray(lax.fori_loop(0, 3, loop_body, jnp.asarray(IMG)))
    got = timing._loop(lambda x: x[::2, ::2, :], torch.from_numpy(IMG), 3).numpy()
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("stat", ["min", "median"])
@pytest.mark.parametrize("case", list(CASES))
def test_device_loop_rate_on_the_cpu(case, stat):
    img, _, body = CASES[case]
    seen = []

    def watched(x):
        seen.append(x.device)
        return body(x)

    sec = device_loop_rate(watched, torch.from_numpy(img), iters=3, repeats=2, stat=stat)
    assert isinstance(sec, float) and math.isfinite(sec) and sec > 0
    assert set(seen) == {torch.device("cpu")}  # the caller's device, not moved


def test_device_loop_rate_takes_a_numpy_input_on_the_host():
    sec = device_loop_rate(lambda x: 255 - x, IMG, iters=2, repeats=1)
    assert math.isfinite(sec) and sec > 0


def test_device_loop_rate_reports_the_floor_when_every_pair_underflows(monkeypatch):
    clock = iter(range(100))  # every run takes one tick, so t - base is 0
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(clock))
    assert device_loop_rate(lambda x: x, torch.from_numpy(IMG), iters=2, repeats=3) == 1e-9


@pytest.mark.parametrize("fn", [lambda x: 255 - x, lambda x: (x, x.sum())],
                         ids=["tensor", "tuple"])
def test_dispatch_time_on_the_cpu(fn):
    sec = dispatch_time(fn, torch.from_numpy(IMG), repeats=2)
    assert isinstance(sec, float) and math.isfinite(sec) and sec > 0
