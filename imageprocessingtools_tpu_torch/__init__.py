"""imageprocessingtools_tpu_torch — the PyTorch + CUDA port for NVIDIA Hopper.

Counterpart of ``imageprocessingtools_tpu`` (the JAX package, which stays the
reference). It carries the reference CLI pipeline, the flagship fused
pipeline, the presets and batched serving:

  codec/     host PPM-family codec (numpy) and the native C++ batch codec
                                                       (ref: ppmx-edward.c:221-456)
  ops/       torch ops on HWC uint8 tensors            (ref: ppmx-edward.c:477-1003)
  kernels/   hand-written CUDA kernels (csrc/*.cu) and their plain torch versions
  models/    named preset pipelines
  parallel/  batches of images over one device or a mesh of devices, and
             one image in row bands over a mesh (spatial)
  pipeline   fixed-order op pipeline                   (ref: ppmx-edward.c:1053-1172)
  cli        flag-compatible command line              (ref: ppmx-edward.c:117-205)
  serving    batched files -> decode -> device -> encode, and its CLI ``serve``

The device comes from ``IPT_DEVICE`` (``cuda`` by default, or ``cpu``). The
kernels build with nvcc at first use; importing the package builds nothing.
"""

__version__ = "0.1.0"

from imageprocessingtools_tpu_torch.codec.ppm import (  # noqa: F401
    FILETYPE_PBM,
    FILETYPE_PGM,
    FILETYPE_PPM,
    PPMError,
    decode_pnm,
    decode_ppm,
    encode_ppm,
    read_pnm,
    read_ppm,
    write_ppm,
)
from imageprocessingtools_tpu_torch.kernels.fused import (  # noqa: F401
    fused_pipeline,
    fused_pipeline_mega,
    fused_pipeline_staged,
)
from imageprocessingtools_tpu_torch.ops import (  # noqa: F401
    apply_lut,
    box_blur,
    brightness,
    contrast,
    equalize_histogram,
    flip_horizontal,
    flip_vertical,
    gaussian_blur,
    grayscale,
    histogram,
    invert,
    mono_dither,
    pack_bits_device,
    resize,
    resize_width,
    resize_width_exact,
    rotate,
    rotate_exact,
    sharpen,
    sobel,
    threshold,
)
from imageprocessingtools_tpu_torch.parallel import (  # noqa: F401
    default_mesh,
    fused_pipeline_spatial,
    preset_pipeline_spatial,
    resize_width_spatial,
    rotate_spatial,
)
from imageprocessingtools_tpu_torch.pipeline import PipelineConfig, run_pipeline  # noqa: F401
