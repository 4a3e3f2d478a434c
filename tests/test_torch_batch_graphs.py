"""The port's batched compiled dispatch (``utils/graphs.py::batched``, the
counterpart of ``jax.jit(jax.vmap(fn))``) and what it needs of the ops, on
the CPU.

A CUDA graph runs only on a card (``tests/test_torch_kernels_cuda.py``);
here are its pure parts (the grouping, the byte bound's evictions, the
mapping of capture errors), the CPU's stand-in for capture (a second call
of every serving task uploads nothing from the host), the tables that
replace per-call uploads and the capture's hold on the device tables, the
task callables' caches, and the batch form's CPU path (the eager loop,
group by group) against the eager loop over the whole batch and the JAX
package's ``process_batch``. Tolerance: none against
the port's own eager loop; against the JAX package, none except for chains
with a resize or a rotation, where that package's ``float_stage_budget``
applies (the port's are exact, the JAX package's are float32).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu import serving as jax_serving
from imageprocessingtools_tpu.ops import _exact as jax_exact
from imageprocessingtools_tpu.ops import color as jax_color
from imageprocessingtools_tpu.ops import packing as jax_packing
from imageprocessingtools_tpu.ops.common import float_stage_budget as jax_budget
from imageprocessingtools_tpu.pipeline import PipelineConfig as JaxConfig
from imageprocessingtools_tpu_torch import serving
from imageprocessingtools_tpu_torch.kernels import TooLarge, core, rotate
from imageprocessingtools_tpu_torch.kernels import resize as k9
from imageprocessingtools_tpu_torch.ops import _exact, color, dither, packing
from imageprocessingtools_tpu_torch.pipeline import PipelineConfig
from imageprocessingtools_tpu_torch.utils import graphs
from tests.conftest import make_gradient, make_image

CPU = torch.device("cpu")
PRESET_NAMES = ("edge_detect", "enhance", "print_ready", "thumbnail")
RESIZE_ROTATE = dict(new_width=20, angle=30.0)
FANOUT = ("edge_detect", dict(gray=True), RESIZE_ROTATE)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPT_DEVICE", "cpu")


def _batch(n, h, w):
    return np.stack([make_image(h, w, seed=i) if i % 2 == 0 else make_gradient(h, w)
                     for i in range(n)])


def _port_task(task):
    """A task in the port's terms: a preset name, a PipelineConfig, or a
    tuple of these (a fan-out); ``task`` gives configs as dicts."""
    if isinstance(task, tuple):
        return tuple(_port_task(t) for t in task)
    return PipelineConfig(**task) if isinstance(task, dict) else task


def _jax_task(task):
    if isinstance(task, tuple):
        return tuple(_jax_task(t) for t in task)
    return JaxConfig(**task) if isinstance(task, dict) else task


def _budget(task) -> int:
    """The JAX package's budget for one element of a task."""
    if task == "thumbnail":
        return jax_budget(True, False)
    if isinstance(task, dict):
        return jax_budget(task.get("new_width") is not None, task.get("angle") is not None)
    return 0


# ---------------------------------------------------------------------------
# Step 0: a capture keeps the C's allocation surface.
# ---------------------------------------------------------------------------

def _body(x):
    return x


@pytest.mark.parametrize("error", [
    MemoryError("host"), torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"),
    TooLarge("gray_gauss: 70000x70000 is too large"), KeyboardInterrupt(),
], ids=lambda e: type(e).__name__)
def test_capture_failure_keeps_allocation_errors_as_they_are(error):
    assert graphs.capture_failure(_body, error) is error
    with pytest.raises(type(error)) as raised:
        graphs._fail(_body, error)
    assert raised.value is error


@pytest.mark.parametrize("error", [
    RuntimeError("operation not permitted when stream is capturing"),
    ValueError("bad value"), TypeError("bad type"),
    RuntimeError("CUDA error: operation failed due to a previous error during capture"),
], ids=lambda e: f"{type(e).__name__}-{str(e)[:12]}")
def test_capture_failure_wraps_everything_else(error):
    failure = graphs.capture_failure(_body, error)
    assert isinstance(failure, graphs.CaptureError) and not isinstance(failure, MemoryError)
    assert "_body cannot be captured in a CUDA graph" in str(failure) and str(error) in str(failure)
    with pytest.raises(graphs.CaptureError) as raised:
        graphs._fail(_body, error)
    assert raised.value.__cause__ is error


# ---------------------------------------------------------------------------
# Step 1: the tables that were uploaded on every call.
# ---------------------------------------------------------------------------

def test_the_dither_table_is_made_once_and_is_the_per_call_one():
    table = dither._thresholds(CPU)
    assert dither._thresholds(CPU) is table
    per_call = torch.as_tensor(_exact.BAYER_THRESHOLD_INT, device=CPU)
    assert table.dtype == per_call.dtype and torch.equal(table, per_call)
    np.testing.assert_array_equal(table.numpy(), jax_exact.BAYER_THRESHOLD_INT)


def test_the_packing_weights_are_made_once_and_are_the_per_call_ones():
    weights = packing._weights(CPU)
    assert packing._weights(CPU) is weights
    assert torch.equal(weights, torch.tensor(packing._WEIGHTS, dtype=torch.int32))
    one_hot = np.eye(8, dtype=np.uint8)  # bit k of a byte alone: its weight
    np.testing.assert_array_equal(np.asarray(jax_packing.pack_bits_device(one_hot))[:, 0],
                                  weights.numpy())


@pytest.mark.parametrize("factor", [0.5, 1.37, 1.5, 2.0])
def test_the_contrast_table_is_made_once_and_is_the_per_call_one(factor):
    table = color._contrast_table(factor, CPU)
    assert color._contrast_table(factor, CPU) is table
    per_call = torch.from_numpy(color._contrast_lut(factor)).to(CPU)
    assert table.dtype == torch.uint8 and torch.equal(table, per_call)
    values = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        color.contrast(torch.from_numpy(values), factor).numpy(),
        np.asarray(jax_color.contrast(values, factor)))


# ---------------------------------------------------------------------------
# Step 2: one callable per task, as in JAX.
# ---------------------------------------------------------------------------

def test_the_task_callables_are_cached_with_the_jax_sizes():
    for name in ("_pipeline_fn", "_preset_pipeline_fn", "_fanout_pipeline_fn"):
        assert (getattr(serving, name).cache_info().maxsize
                == getattr(jax_serving, name).cache_info().maxsize), name
    assert serving._pipeline_fn(PipelineConfig(**RESIZE_ROTATE)) is \
        serving._pipeline_fn(PipelineConfig(**RESIZE_ROTATE))
    assert serving._pipeline_fn(PipelineConfig(gray=True)) is not \
        serving._pipeline_fn(PipelineConfig(mono=True))
    for name in PRESET_NAMES:
        assert serving._preset_pipeline_fn(name) is serving._preset_pipeline_fn(name)
    fanout = _port_task(FANOUT)
    assert serving._fanout_pipeline_fn(fanout) is serving._fanout_pipeline_fn(_port_task(FANOUT))
    assert serving._task_fn(fanout)[0] is serving._task_fn(_port_task(FANOUT))[0]


# ---------------------------------------------------------------------------
# The CPU's stand-in for capture: a second call uploads nothing.
# ---------------------------------------------------------------------------

def _refuse_uploads(monkeypatch):
    """Make torch.tensor and torch.as_tensor raise when given host data and
    a device, and torch.from_numpy raise whenever it is called."""
    def guarded(real, device_at):
        def call(data, *args, **kwargs):
            device = kwargs.get("device", args[device_at - 1] if len(args) >= device_at else None)
            if device is not None and not isinstance(data, torch.Tensor):
                raise AssertionError(f"{real.__name__} uploads {type(data).__name__} to {device}")
            return real(data, *args, **kwargs)
        return call

    def from_numpy(array):
        raise AssertionError(f"torch.from_numpy of {array.shape} on a second call")

    monkeypatch.setattr(torch, "tensor", guarded(torch.tensor, 99))  # device is keyword-only
    monkeypatch.setattr(torch, "as_tensor", guarded(torch.as_tensor, 2))
    monkeypatch.setattr(torch, "from_numpy", from_numpy)


@pytest.mark.parametrize("task", list(PRESET_NAMES) + [
    ("-gray", dict(gray=True)), ("-w64 -r30", dict(new_width=64, angle=30.0)),
    ("-w48 -r30 -mono -fv", dict(new_width=48, angle=30.0, mono=True, flip_v=True)),
], ids=lambda t: t if isinstance(t, str) else t[0])
def test_a_second_call_uploads_nothing(task, monkeypatch):
    if isinstance(task, tuple):
        task = task[1]
    one, _ = serving._task_fn(_port_task(task))
    img = torch.from_numpy(make_image(36, 60, seed=3))
    first = one(img)
    with monkeypatch.context() as patched:
        _refuse_uploads(patched)
        second = one(img)
    assert torch.equal(first, second)


def test_a_second_call_of_the_fanout_and_of_contrast_uploads_nothing(monkeypatch):
    one, _ = serving._task_fn(_port_task((dict(gray=True), dict(new_width=64, angle=30.0))))
    img = torch.from_numpy(make_image(36, 60, seed=4))
    first = one(img), [color.contrast(img, f) for f in (0.5, 1.37, 1.5, 2.0)]
    with monkeypatch.context() as patched:
        _refuse_uploads(patched)
        second = one(img), [color.contrast(img, f) for f in (0.5, 1.37, 1.5, 2.0)]
    for a, b in zip(first[0] + tuple(first[1]), second[0] + tuple(second[1])):
        assert torch.equal(a, b)


def test_the_upload_guard_catches_a_per_call_upload(monkeypatch):
    with monkeypatch.context() as patched:
        _refuse_uploads(patched)
        with pytest.raises(AssertionError, match="uploads tuple"):
            torch.tensor(packing._WEIGHTS, dtype=torch.int32, device=CPU)
        with pytest.raises(AssertionError, match="uploads ndarray"):
            torch.as_tensor(_exact.BAYER_THRESHOLD_INT, device=CPU)
        with pytest.raises(AssertionError, match="from_numpy"):
            torch.from_numpy(color._contrast_lut(1.5))
        assert torch.as_tensor(torch.zeros(2), device=CPU).shape == (2,)  # a tensor is no upload


# ---------------------------------------------------------------------------
# The grouping and the byte bound: pure functions.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", [1, 3, 8])
@pytest.mark.parametrize("n", [0, 1, 2, 7, 8, 9, 15, 16, 17, 255, 256, 257])
def test_spans_cut_n_images_into_groups_and_a_remainder(n, group):
    spans = graphs.spans(n, group)
    assert [i for start, count in spans for i in range(start, start + count)] == list(range(n))
    assert len(spans) == -(-n // group)
    assert all(count == group for _, count in spans[:n // group])
    if n % group:
        assert spans[-1] == (n - n % group, n % group)


@pytest.mark.parametrize("n, group", [(-1, 3), (4, 0)])
def test_spans_refuse_nonsense(n, group):
    with pytest.raises(ValueError):
        graphs.spans(n, group)


@pytest.mark.parametrize("image_bytes, group", [
    (2160 * 3840 * 3, 10), (1080 * 1920 * 3, 43), (4320 * 7680 * 3, 2), (4096 * 8192 * 3, 2),
    (27000 * 27000 * 3, 1), (36 * 60 * 3, 41425), (512 * 512 * 3, 341), (0, 65535),
    (36 * 36 * 3, 65535), (graphs.GROUP_INPUT_BYTES, 1), (graphs.GROUP_INPUT_BYTES // 3, 3),
])
def test_group_size_bounds_a_groups_input(image_bytes, group):
    assert graphs.GROUP_INPUT_BYTES == 256 << 20
    assert graphs.GROUP_IMAGES == 65535  # a batched kernel's grid axis
    assert graphs.group_size(image_bytes) == group
    assert group == 1 or group * image_bytes <= graphs.GROUP_INPUT_BYTES
    if image_bytes and group < graphs.GROUP_IMAGES:
        assert (group + 1) * image_bytes > graphs.GROUP_INPUT_BYTES  # no larger group fits


@pytest.mark.parametrize("sizes, bound, dropped", [
    ([], 10, 0), ([5], 1, 0), ([3, 3, 3], 9, 0), ([3, 3, 3], 6, 1), ([3, 3, 3], 2, 2),
    ([10, 1, 1], 2, 1), ([1, 1, 10], 2, 2), ([4, 4, 4, 4], 12, 1),
])
def test_evictions_keep_the_bound_and_the_newest_graph(sizes, bound, dropped):
    assert graphs.evictions(sizes, bound) == dropped
    kept = sizes[dropped:]
    assert len(kept) == 1 or sum(kept) <= bound


# ---------------------------------------------------------------------------
# The batch form's CPU path against the eager loop and the JAX package.
# ---------------------------------------------------------------------------

_TASKS = list(PRESET_NAMES) + [RESIZE_ROTATE, FANOUT]


def _groups_of(monkeypatch, run, image_bytes, group):
    """Make G ``group`` for images of ``image_bytes``; the list that the
    sizes of the groups that ``run`` (a ``graphs.batched``) runs go to."""
    monkeypatch.setattr(graphs, "GROUP_INPUT_BYTES", group * image_bytes)
    seen, real = [], run._body

    def body(batch):
        seen.append(batch.shape[0])
        return real(batch)

    monkeypatch.setattr(run, "_body", body)
    return seen


@pytest.mark.parametrize("task", _TASKS, ids=str)
def test_batched_on_the_cpu_equals_the_eager_loop_and_jax(task, monkeypatch):
    imgs = _batch(11, 24, 40)
    one, _ = serving._task_fn(_port_task(task))
    run = graphs.batched(one)
    with monkeypatch.context() as patched:
        seen = _groups_of(patched, run, imgs[0].nbytes, 8)
        got = run(imgs, CPU)
    assert seen == [8, 3]  # a group of 8, then one of 3
    eager = graphs.eager_batch(one, torch.from_numpy(imgs))
    want, _ = jax_serving.process_batch(imgs, _jax_task(task))
    elements = task if isinstance(task, tuple) else (task,)
    if not isinstance(task, tuple):
        got, eager, want = (got,), (eager,), (want,)
    for element, g, e, w in zip(elements, got, eager, want):
        assert g.device == CPU and torch.equal(g, e), element
        w = np.asarray(w)
        assert g.shape == w.shape, element
        err = int(np.abs(g.numpy().astype(np.int32) - w.astype(np.int32)).max())
        assert err <= _budget(element), (element, err)


def test_batched_on_the_cpu_returns_fresh_tensors_in_one_group(monkeypatch):
    imgs = _batch(3, 8, 12)
    run = graphs.batched(lambda x: x[..., 0])
    seen = _groups_of(monkeypatch, run, imgs[0].nbytes, 4)
    first = run(imgs, CPU)
    second = run(imgs[::-1].copy(), CPU)
    assert seen == [3, 3]
    assert torch.equal(first, torch.from_numpy(imgs[..., 0]))
    assert torch.equal(second, torch.from_numpy(imgs[::-1, ..., 0].copy()))


# ---------------------------------------------------------------------------
# The device tables that captured launches read are held by the capture.
# ---------------------------------------------------------------------------

_DEVICE_TABLES = {
    "K8 chain": lambda: core._chain_table((("contrast", 1.5),), CPU),
    "contrast": lambda: color._contrast_table(1.5, CPU),
    "K9 passes": lambda: k9.device_passes(36, 60, 20, CPU),
    "K1 plan": lambda: rotate._device_plan(36, 60, 30.0, CPU),
}


@pytest.mark.parametrize("name", list(_DEVICE_TABLES))
def test_a_capture_holds_every_device_table_it_is_given(name, monkeypatch):
    make = _DEVICE_TABLES[name]
    first = make()  # made outside a capture: held by nothing
    assert not graphs.capturing()
    monkeypatch.setattr(graphs, "_holds", [])
    assert graphs.capturing()
    again = make()
    assert again is first  # cached
    assert len(graphs._holds) == 1 and graphs._holds[0] is first
    make()
    assert len(graphs._holds) == 2  # held once per launch that reads it; the graph keeps a list


def test_device_tables_keep_their_caches_controls():
    for table, size in ((core._chain_table, 64), (color._contrast_table, 64),
                        (k9.device_passes, 32), (rotate._device_plan, 32)):
        assert table.cache_info().maxsize == size
        table.cache_clear()
        assert table.cache_info().currsize == 0
