"""Geometric ops: flips, orthogonal rotations, arbitrary-angle rotation.

Counterpart of ``imageprocessingtools_tpu/ops/geometry.py``. Flips and
90/180/270 rotations are index permutations (``ppmx-edward.c:888-913``,
``:714-725``). Any other angle goes to K1 (``kernels/rotate.py``), which is
f64 in the reference's order and so byte-identical to the C at every size:
the JAX package's double-f32 geometry, +-1 budget, host audit and
``strict=`` fallback have no counterpart here.

The ``*_batch`` forms take uint8[N, H, W(, C)] and do the same to each image,
as ``jax.vmap`` of the JAX package's op: the permutations over axes 1 and 2,
and any other angle one launch of K1 over the batch.
"""

from __future__ import annotations

import numpy as np
import torch

from imageprocessingtools_tpu_torch.kernels.rotate import rotate_bicubic, rotate_bicubic_batch


def flip_vertical(img: torch.Tensor) -> torch.Tensor:
    """Row reversal (``ppmx-edward.c:898-904``)."""
    return torch.flip(img, dims=(0,))


def flip_horizontal(img: torch.Tensor) -> torch.Tensor:
    """Column reversal (``ppmx-edward.c:906-911``)."""
    return torch.flip(img, dims=(1,))


def rotate90(img: torch.Tensor) -> torch.Tensor:
    """CW 90: out[x][H-1-y] = in[y][x] (``ppmx-edward.c:714-717``)."""
    return torch.flip(img.transpose(0, 1), dims=(1,)).contiguous()


def rotate180(img: torch.Tensor) -> torch.Tensor:
    return torch.flip(img, dims=(0, 1))


def rotate270(img: torch.Tensor) -> torch.Tensor:
    """CCW 90: out[W-1-y][x] = in[x][y] (``ppmx-edward.c:722-725``)."""
    return torch.flip(img.transpose(0, 1), dims=(0,)).contiguous()


def rotate(img: torch.Tensor, angle_deg: float) -> torch.Tensor:
    """CW rotation by ``angle_deg`` with the reference's exact zone logic.

    0/90/180/270 take the permutation paths (``ppmx-edward.c:701-725``);
    any other angle runs K1 on a CUDA tensor and its plain version on a
    CPU tensor.
    """
    angle = float(angle_deg)
    if angle == 0.0:
        return img
    if angle == 90.0:
        return rotate90(img)
    if angle == 180.0:
        return rotate180(img)
    if angle == 270.0:
        return rotate270(img)
    return rotate_bicubic(img.contiguous(), angle)


def flip_vertical_batch(imgs: torch.Tensor) -> torch.Tensor:
    """``flip_vertical`` of each image of uint8[N, H, W(, C)]."""
    return torch.flip(imgs, dims=(1,))


def flip_horizontal_batch(imgs: torch.Tensor) -> torch.Tensor:
    """``flip_horizontal`` of each image of uint8[N, H, W(, C)]."""
    return torch.flip(imgs, dims=(2,))


def rotate_batch(imgs: torch.Tensor, angle_deg: float) -> torch.Tensor:
    """``rotate`` of each image of uint8[N, H, W(, C)]: 0/90/180/270 as
    permutations of axes 1 and 2, any other angle one launch of K1 over the
    batch on a CUDA tensor (its plain batch version on a CPU tensor)."""
    angle = float(angle_deg)
    if angle == 0.0:
        return imgs
    if angle == 90.0:
        return torch.flip(imgs.transpose(1, 2), dims=(2,)).contiguous()
    if angle == 180.0:
        return torch.flip(imgs, dims=(1, 2))
    if angle == 270.0:
        return torch.flip(imgs.transpose(1, 2), dims=(1,)).contiguous()
    return rotate_bicubic_batch(imgs.contiguous(), angle)


def rotate_exact(img, angle_deg: float) -> np.ndarray:
    """Host rotation returning numpy, the JAX package's name for the
    bit-exact mode; here every rotation is exact, so this is `rotate` on a
    CPU tensor."""
    return rotate(torch.as_tensor(np.asarray(img)), angle_deg).numpy()
