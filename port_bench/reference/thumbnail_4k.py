"""The thumbnail's reference: ``-w<new_width>`` (the reference tool's resize,
``resize.py``) in float64, as the configuration states; its control in
float32. Answers are P6 files with the input's maxval."""

from __future__ import annotations

import torch

from port_bench.reference import pnm, resize


def expected(images: torch.Tensor, config: dict) -> torch.Tensor:
    return resize.resize_width(images, config["new_width"], torch.float64)


def control(images: torch.Tensor, config: dict) -> torch.Tensor:
    return resize.resize_width(images, config["new_width"], torch.float32)


def file_bytes(out: torch.Tensor, config: dict) -> bytes:
    """The P6 file of one output image uint8[H, W, 3]."""
    return (pnm.p6(out.shape[1], out.shape[0], config["max_color"])
            + out.contiguous().cpu().numpy().tobytes())
