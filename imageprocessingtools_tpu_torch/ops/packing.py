"""Device-side P4 bit packing for the batched encode path.

Counterpart of ``imageprocessingtools_tpu/ops/packing.py``. The reference
packs bits on the host one byte at a time (``ppmx-edward.c:268-284``); for
batched serving the packing runs on the device: rows are zero-padded to a
byte, grouped by 8 and weighted MSB-first [128, 64, ..., 1], which is
integer math and equal to ``np.packbits(axis=-1)``. The weights are a table
made once per device, so that a CUDA graph can capture the packing
(``utils/graphs.py``). The packing is the span ``packing.p4``
(``utils.profiling``): on a card it runs at a capture of a graph of the
task, never at a replay.
"""

from __future__ import annotations

import functools

import torch

from imageprocessingtools_tpu_torch.utils.profiling import span

_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


@functools.cache
def _weights(device: torch.device) -> torch.Tensor:
    """uint8[8] MSB-first bit weights on ``device``, made once per device."""
    return torch.tensor(_WEIGHTS, dtype=torch.uint8, device=device)


def pack_bits_device(bits: torch.Tensor) -> torch.Tensor:
    """uint8[..., H, W] in {0, 1} -> uint8[..., H, ceil(W/8)], MSB-first."""
    w = bits.shape[-1]
    row_bytes = -(-w // 8)
    pad = row_bytes * 8 - w
    with span("packing.p4"):
        if pad:
            bits = torch.nn.functional.pad(bits, (0, pad))
        # A bit times its weight and the sum of a byte's eight fit a byte, so
        # the packing runs in uint8: no wider copy of the bits.
        grouped = bits.reshape(bits.shape[:-1] + (row_bytes, 8))
        return (grouped * _weights(bits.device)).sum(-1, dtype=torch.uint8)
