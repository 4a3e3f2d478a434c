"""Device-side P4 bit packing for the batched encode path.

Counterpart of ``imageprocessingtools_tpu/ops/packing.py``. The reference
packs bits on the host one byte at a time (``ppmx-edward.c:268-284``); for
batched serving the packing runs on the device: rows are zero-padded to a
byte, grouped by 8 and weighted MSB-first [128, 64, ..., 1], which is
integer math and equal to ``np.packbits(axis=-1)``.
"""

from __future__ import annotations

import torch

_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_bits_device(bits: torch.Tensor) -> torch.Tensor:
    """uint8[..., H, W] in {0, 1} -> uint8[..., H, ceil(W/8)], MSB-first."""
    w = bits.shape[-1]
    row_bytes = -(-w // 8)
    pad = row_bytes * 8 - w
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    weights = torch.tensor(_WEIGHTS, dtype=torch.int32, device=bits.device)
    grouped = bits.reshape(bits.shape[:-1] + (row_bytes, 8)).to(torch.int32)
    return (grouped * weights).sum(-1).to(torch.uint8)
