"""Preset pipelines ("models"): named op compositions.

Counterpart of ``imageprocessingtools_tpu/models``. The reference has one
hard-wired pipeline (resize -> rotate -> gray -> mono -> flips,
``ppmx-edward.c:1084-1155``); the presets are the reusable pipelines a
serving deployment ships. Each is a ``uint8[H, W, 3] -> uint8[...]``
callable on one image, run on the image's device.
"""

from imageprocessingtools_tpu_torch.models.presets import (  # noqa: F401
    PRESET_FILE_TYPES,
    PRESET_OUTPUT_SHAPES,
    PRESET_P4_FORMS,
    PRESETS,
    edge_detect,
    enhance,
    get_preset,
    preset_output_shape,
    print_ready,
    reference_pipeline,
    thumbnail,
)
