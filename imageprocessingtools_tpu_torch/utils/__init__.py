"""Utilities (counterpart of ``imageprocessingtools_tpu/utils``)."""

from imageprocessingtools_tpu_torch.utils.timing import (  # noqa: F401
    device_loop_rate,
    dispatch_time,
)
