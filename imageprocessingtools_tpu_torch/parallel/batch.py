"""Batch API: a single-image function over a leading dimension, on one
device or split over a mesh of devices.

Counterpart of ``imageprocessingtools_tpu/parallel/batch.py``. There a batch
is ``vmap`` under ``jit``, sharded over a device mesh. Here it is a loop over
the leading dimension on a device's current stream: the images are
independent, every kernel keeps its single-image signature, and the launches
of one image queue behind those of the one before. A mesh is a tuple of
devices (``default_mesh``); ``batch_apply`` gives each device an equal shard
of the batch, uploaded once, and returns the shards' outputs, which the
caller joins where it needs them (``gather``). A mesh may name a device more
than once. The JAX module's size gate on the mega kernel has no counterpart:
K2 has no size limit.
"""

from __future__ import annotations

import contextlib

import torch

from imageprocessingtools_tpu_torch.device import get_device
from imageprocessingtools_tpu_torch.kernels.fused import fused_pipeline_mega


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


def _stack(outs: list):
    if isinstance(outs[0], tuple):
        return tuple(torch.stack([o[k] for o in outs]) for k in range(len(outs[0])))
    return torch.stack(outs)


def batch_apply(fn, images, mesh: tuple | None = None):
    """Apply a single-image op or pipeline to a batch.

    ``fn``: uint8[H, W, C] tensor -> tensor, or a tuple of tensors.
    ``images``: uint8[N, H, W, C] (numpy or torch). Without ``mesh`` the
    batch moves once to the configured device (``device.get_device``) and
    the result is the outputs stacked along a new leading dimension (a
    tuple of stacks for a tuple-returning ``fn``). With ``mesh`` (a tuple of
    devices) N must divide into ``len(mesh)`` equal shards; shard k moves
    once to ``mesh[k]`` and runs there, and the result is the list of the
    shards' stacks, in order (``gather`` joins them).
    """
    batch = torch.as_tensor(images)
    if batch.shape[0] == 0:
        raise ValueError("batch_apply: empty batch")
    if mesh is None:
        batch = batch.to(get_device())
        return _stack([fn(batch[i]) for i in range(batch.shape[0])])
    mesh = default_mesh(mesh)
    n = len(mesh)
    if batch.shape[0] % n:
        raise ValueError(
            f"batch size {batch.shape[0]} not divisible by the mesh's {n} devices; pad the batch")
    size = batch.shape[0] // n
    shards = []
    for k, dev in enumerate(mesh):
        with on_device(dev):
            shard = batch[k * size:(k + 1) * size].to(dev)
            shards.append(_stack([fn(shard[i]) for i in range(size)]))
    return shards


def gather(shards: list, device="cpu"):
    """Join ``batch_apply``'s shards along the leading dimension on
    ``device`` (a tuple of joins for tuple outputs)."""
    if isinstance(shards[0], tuple):
        return tuple(gather([s[k] for s in shards], device) for k in range(len(shards[0])))
    return torch.cat([s.to(device) for s in shards])


def batched_fused_pipeline(images, mesh: tuple | None = None):
    """Batched flagship pipeline (gray -> 5x5 Gaussian -> histogram
    equalization): uint8[N, H, W, 3] -> uint8[N, H, W], each image through
    ``fused_pipeline_mega`` (K2 and K3 on a CUDA device); with ``mesh``,
    the shards' outputs (see ``batch_apply``)."""
    return batch_apply(fused_pipeline_mega, images, mesh)
