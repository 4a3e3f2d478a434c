"""Batch API on one device: a single-image function over a leading dimension.

Counterpart of ``imageprocessingtools_tpu/parallel/batch.py`` for one device.
There a batch is ``vmap`` under ``jit``, sharded over a device mesh. Here it is
a loop over the leading dimension on the current stream: the images are
independent, every kernel keeps its single-image signature, and the launches
of one image queue behind those of the one before. Sharding a batch over
several devices (the JAX module's ``mesh`` argument and ``default_mesh``) is
not ported; nor is its size gate on the mega kernel, which no longer has a
size limit.
"""

from __future__ import annotations

import torch

from imageprocessingtools_tpu_torch.device import get_device
from imageprocessingtools_tpu_torch.kernels.fused import fused_pipeline_mega


def batch_apply(fn, images):
    """Apply a single-image op or pipeline to a batch.

    ``fn``: uint8[H, W, C] tensor -> tensor, or a tuple of tensors.
    ``images``: uint8[N, H, W, C] (numpy or torch), moved once to the
    configured device (``device.get_device``). Returns the outputs stacked
    along a new leading dimension; a tuple-returning ``fn`` gives a tuple of
    stacks.
    """
    batch = torch.as_tensor(images).to(get_device())
    if batch.shape[0] == 0:
        raise ValueError("batch_apply: empty batch")
    outs = [fn(batch[i]) for i in range(batch.shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack([o[k] for o in outs]) for k in range(len(outs[0])))
    return torch.stack(outs)


def batched_fused_pipeline(images):
    """Batched flagship pipeline (gray -> 5x5 Gaussian -> histogram
    equalization): uint8[N, H, W, 3] -> uint8[N, H, W], each image through
    ``fused_pipeline_mega`` (K2 and K3 on a CUDA device)."""
    return batch_apply(fused_pipeline_mega, images)
