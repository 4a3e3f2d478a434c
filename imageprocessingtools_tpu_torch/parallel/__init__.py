"""Batches of images on one device (counterpart of
``imageprocessingtools_tpu/parallel``, its one-device half)."""

from imageprocessingtools_tpu_torch.parallel.batch import (  # noqa: F401
    batch_apply,
    batched_fused_pipeline,
)
