"""The reference tool's own pipeline, ``-w<new_width> -r<angle> -gray``, in
its fixed order (``doProcessPPM``, ``ppmx-edward.c:1084-1140``): the resize
(``resize.py``), the rotation (``rotate.py``), both float64 as the
configuration states, then gray as (r + g + b) // 3 in integers. Its control
runs the resize and the rotation in float32. Answers are uint8[N, H', W'].
"""

from __future__ import annotations

import torch

from port_bench.reference import resize, rotate

# No matrix product is expected here; the guard keeps float32 ones out of TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def gray(images: torch.Tensor) -> torch.Tensor:
    """uint8[N, H, W, 3] -> uint8[N, H, W]: (r + g + b) // 3 (``gray``, ``:986-1003``)."""
    return (images.to(torch.int32).sum(-1) // 3).to(torch.uint8)


def _pipeline(images: torch.Tensor, config: dict, dtype: torch.dtype) -> torch.Tensor:
    out = resize.resize_width(images, config["new_width"], dtype)
    return gray(rotate.rotate(out, config["angle"], dtype))


def expected(images: torch.Tensor, config: dict) -> torch.Tensor:
    return _pipeline(images, config, torch.float64)


def control(images: torch.Tensor, config: dict) -> torch.Tensor:
    return _pipeline(images, config, torch.float32)
