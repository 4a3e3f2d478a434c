"""Batch API: a single-image function over a leading dimension, on one
device or split over a mesh of devices.

Counterpart of ``imageprocessingtools_tpu/parallel/batch.py``. There a batch
is ``vmap`` under ``jit`` (``_jitted_vmap``, ``_shard_mapped_vmap``),
sharded over a device mesh. Here it is ``utils.graphs.batched``: on a CUDA
device, replays of CUDA graphs over groups of images, each graph holding
its group's batch form where the function has one (each kernel launched
once over the group, as ``jax.vmap`` makes one kernel over the batch), else
its per-image launches, every call running the plan kept for its batch's
device, shape, dtype and strides; on a CPU device the same group body,
eagerly. A mesh is
a tuple of devices (``default_mesh``); ``batch_apply`` gives each device an
equal shard of the batch, runs it there on graphs of that device's own (no
graph spans two cards), and returns the shards' outputs, which the caller
joins where it needs them (``gather``). A mesh may name a device more than
once. The JAX module's size gate on the mega kernel has no counterpart: K2
has no size limit.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from imageprocessingtools_tpu_torch.device import get_device
from imageprocessingtools_tpu_torch.kernels.fused import fused_pipeline_mega
from imageprocessingtools_tpu_torch.utils import graphs, profiling


def _indexed(device) -> torch.device:
    """``device`` as a ``torch.device`` that names its card (a tensor's
    ``.device`` always does, so the two compare equal)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def default_mesh(devices=None) -> tuple:
    """The devices to split work over: ``devices`` as ``torch.device``s that
    name their card, or every CUDA card that torch sees, or ``(cpu,)`` under
    ``IPT_DEVICE=cpu``."""
    if devices is not None:
        return tuple(_indexed(d) for d in devices)
    dev = get_device()
    if dev.type == "cpu":
        return (dev,)
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def on_device(device: torch.device):
    """A context that makes ``device`` current where it is a CUDA card, so
    that what the code inside allocates without a device lands there."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


@functools.lru_cache(maxsize=64)
def _batched(fn) -> graphs.Batched:
    """The one ``graphs.batched(fn)`` that ``batch_apply`` keeps for ``fn``,
    with its plans."""
    return graphs.batched(fn)


def batch_apply(fn, images, mesh: tuple | None = None):
    """Apply a single-image op or pipeline to a batch.

    ``fn``: uint8[H, W, C] tensor -> tensor, or a tuple of tensors.
    ``images``: uint8[N, H, W, C] (numpy or torch). Without ``mesh`` the
    batch runs on the configured device (``device.get_device``) and the
    result is the outputs stacked along a new leading dimension (a tuple of
    stacks for a tuple-returning ``fn``). With ``mesh`` (a tuple of devices)
    N must divide into ``len(mesh)`` equal shards; shard k runs on
    ``mesh[k]``, and the result is the list of the shards' stacks, in order
    (``gather`` joins them). On a CUDA device every group of images is one
    replay of a captured graph (``graphs.batched``): a group on the card is
    bound into the graph's kernels where it lies, and its output written in
    place, where its plan places them and their addresses are aligned
    (``graphs.bindable``'s two halves); anything else, and every group from
    the host, is copied into the graph's input and its outputs copied out.
    A ``fn`` that cannot be captured raises ``graphs.CaptureError``. The
    outputs are fresh tensors. One ``graphs.batched(fn)`` is kept for each
    ``fn``, so that a repeat call runs the plan its first call made
    (``graphs.Batched``). The call is one ``batch.apply`` span
    (``utils.profiling``).
    """
    with profiling.span("batch.apply"):
        batch = images if isinstance(images, torch.Tensor) else torch.as_tensor(images)
        if batch.shape[0] == 0:
            raise ValueError("batch_apply: empty batch")
        run = _batched(fn)
        if mesh is None:
            return run(batch, _indexed(get_device()))
        mesh = default_mesh(mesh)
        n = len(mesh)
        if batch.shape[0] % n:
            raise ValueError(
                f"batch size {batch.shape[0]} not divisible by the mesh's {n} devices; "
                "pad the batch")
        size = batch.shape[0] // n
        shards = []
        for k, dev in enumerate(mesh):
            with on_device(dev):
                shards.append(run(batch[k * size:(k + 1) * size], dev))
        return shards


def gather(shards: list, device="cpu"):
    """Join ``batch_apply``'s shards along the leading dimension on
    ``device`` (a tuple of joins for tuple outputs)."""
    if isinstance(shards[0], tuple):
        return tuple(gather([s[k] for s in shards], device) for k in range(len(shards[0])))
    return torch.cat([s.to(device) for s in shards])


def batched_fused_pipeline(images, mesh: tuple | None = None):
    """Batched flagship pipeline (gray -> 5x5 Gaussian -> histogram
    equalization): uint8[N, H, W, 3] -> uint8[N, H, W], each image as
    ``fused_pipeline_mega`` gives it, through its batch form (K2 and K3
    once per group of images on a CUDA device); with ``mesh``, the shards'
    outputs (see ``batch_apply``), each card's groups on its own graphs."""
    return batch_apply(fused_pipeline_mega, images, mesh)
