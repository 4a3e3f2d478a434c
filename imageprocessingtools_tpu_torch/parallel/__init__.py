"""Parallelism of the port (counterpart of ``imageprocessingtools_tpu/parallel``).

- `batch`: batches of images, on one device or split over a mesh of
  devices (a tuple of ``torch.device``, ``default_mesh``);
- `spatial`: one image in row bands over a mesh, with halos, histogram
  counts and resampling windows moved between bands as row windows.
"""

from imageprocessingtools_tpu_torch.parallel.batch import (  # noqa: F401
    batch_apply,
    batched_fused_pipeline,
    default_mesh,
)
from imageprocessingtools_tpu_torch.parallel.spatial import (  # noqa: F401
    fused_pipeline_spatial,
    preset_pipeline_spatial,
    resize_width_spatial,
    rotate_spatial,
)
