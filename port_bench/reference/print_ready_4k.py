"""print_ready's reference: gray as (r + g + b) // 3 in integers; the
flagship's 256-bin equalization with its LUT in float32 (``flagship_4k.py``'s
``_equalized``), as the configuration states; then the reference tool's
``-mono`` (``ppmx-edward.c:949-971``) over the equalized gray taken as three
equal channels, written as the C writes it: ``avg`` = (r + g + b) / 3
truncated, the threshold ``m`` = k / 16 read from the C's flat matrix at
``[(x % 4) * 4 + (y % 4)]`` (transposed), and the pixel 0 (white) where
``avg >= m * 255.0`` in float64, else 1 (black); then the C's P4 rows
(``:268-284``): each row zero-padded to a byte, eight pixels a byte with
weights 128 ... 1, summed in int32. Answers are uint8[N, H, ceil(W / 8)].
Its control computes the LUT in bfloat16.
"""

from __future__ import annotations

import torch

from port_bench.reference.flagship_4k import _equalized

# No matrix product is expected here; the guard keeps float32 ones out of TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The C's matrix (``:954``) as k of k / 16, in its flat order.
MATRIX = (2, 16, 3, 13, 10, 6, 11, 7, 4, 14, 1, 15, 12, 8, 9, 5)
WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)  # MSB first


def gray(images: torch.Tensor) -> torch.Tensor:
    """uint8[N, H, W, 3] -> uint8[N, H, W]: (r + g + b) // 3 (``gray``, ``:986-1003``)."""
    return (images.to(torch.int32).sum(-1) // 3).to(torch.uint8)


def mono(rgb: torch.Tensor) -> torch.Tensor:
    """uint8[N, H, W, 3] -> int32[N, H, W], 1 = black (``mono``, ``:949-971``)."""
    h, w = rgb.shape[1], rgb.shape[2]
    avg = rgb.to(torch.int32).sum(-1) // 3
    ys = torch.arange(h, device=rgb.device)[:, None]
    xs = torch.arange(w, device=rgb.device)[None, :]
    matrix = torch.tensor(MATRIX, dtype=torch.float64, device=rgb.device) / 16.0
    m = matrix[(xs % 4) * 4 + (ys % 4)]
    return torch.where(avg.to(torch.float64) >= m * 255.0, 0, 1).to(torch.int32)


def pack(bits: torch.Tensor) -> torch.Tensor:
    """int32[N, H, W] in {0, 1} -> uint8[N, H, ceil(W / 8)]: P4 rows."""
    n, h, w = bits.shape
    row_bytes = (w + 7) // 8
    padded = torch.zeros((n, h, row_bytes * 8), dtype=torch.int32, device=bits.device)
    padded[:, :, :w] = bits
    weights = torch.tensor(WEIGHTS, dtype=torch.int32, device=bits.device)
    return (padded.reshape(n, h, row_bytes, 8) * weights).sum(-1).to(torch.uint8)


def _print_ready(images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    eq = _equalized(gray(images), dtype)
    return pack(mono(eq[..., None].expand(*eq.shape, 3)))


def expected(images: torch.Tensor, config: dict) -> torch.Tensor:
    return _print_ready(images, torch.float32)


def control(images: torch.Tensor, config: dict) -> torch.Tensor:
    return _print_ready(images, torch.bfloat16)
