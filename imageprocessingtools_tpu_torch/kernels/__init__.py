"""Hand-written CUDA kernels (``csrc/*.cu``), their wrappers and plain torch versions.

Counterpart of ``imageprocessingtools_tpu/kernels`` (the Pallas kernels),
whose ``__init__`` names each have a counterpart here (``COUNTERPARTS``).
The flagship's three ``jax.jit`` programs are CUDA graphs here
(``fused.py``, ``utils/graphs.py``). ``TooLarge`` is the wrappers' refusal
of a tensor that one launch cannot take.
"""

from imageprocessingtools_tpu_torch.kernels._build import TooLarge  # noqa: F401
# fused first: it imports ops, whose modules import kernels.core and kernels.rotate.
from imageprocessingtools_tpu_torch.kernels.fused import (  # noqa: F401
    fused_gray_gauss_histeq,
    fused_gray_gauss_histeq_pallas,
    fused_gray_gauss_histeq_pallas_mega,
    fused_pipeline,
    fused_pipeline_mega,
    fused_pipeline_staged,
)
from imageprocessingtools_tpu_torch.kernels.core import (  # noqa: F401
    box_blur,
    fused_elementwise,
    gaussian_blur,
    histogram,
    lut_apply,
    sharpen,
    sobel,
)
from imageprocessingtools_tpu_torch.kernels.rotate import rotate_bicubic  # noqa: F401

# Each name of imageprocessingtools_tpu/kernels/__init__.py -> its port
# counterpart in this package.
COUNTERPARTS = {
    "fused_gray_gauss_histeq": "fused_gray_gauss_histeq",  # graphed mega (no XLA form)
    "fused_gray_gauss_histeq_pallas": "fused_gray_gauss_histeq_pallas",  # graphed staged
    "fused_pipeline_xla": "fused_pipeline",  # the plain torch versions
    "fused_pipeline_pallas": "fused_pipeline_staged",  # K8, K5, K4, K3
    "rotate_blocked_pallas": "rotate_bicubic",  # K1
    "box_blur_pallas": "box_blur",  # K7
    "fused_elementwise_pallas": "fused_elementwise",  # K8
    "gaussian_blur_pallas": "gaussian_blur",  # K5
    "histogram_pallas": "histogram",  # K4
    "lut_apply_pallas": "lut_apply",  # K3
    "sharpen_pallas": "sharpen",  # K7
    "sobel_pallas": "sobel",  # K7
}


def counted_wrappers() -> tuple:
    """Every kernel wrapper, each counting its launches in ``.launches``."""
    from imageprocessingtools_tpu_torch.kernels import core, resize, rotate

    return (rotate.rotate_bicubic, core.gray_gauss_hist, core.gray_gauss,
            core.fused_elementwise, core.lut_apply, core.histogram, core.gaussian_blur,
            core.box_blur, core.sharpen, core.sobel, resize.resize_pass,
            rotate.rotate_bicubic_batch, resize.resize_pass_batch) + core.BATCH_WRAPPERS
