"""Photo-like RGB frames made from a seed, on the device, for every cell.

A frame is a smooth colour field (a coarse random grid upsampled bicubically),
a dozen flat rectangles and ellipses with hard edges laid over it, and mild
Gaussian noise. Its histograms are peaked, as a photograph's are, where numpy
noise's are flat. Every seed gives the same number of frames, shapes and
noise level, so a seed changes the content and never the amount of work.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

GRID = (6, 10)   # the coarse colour grid, rows by columns
SHAPES = 12      # rectangles and ellipses per frame
NOISE = 3.0      # standard deviation of the noise, in grey levels
BLOCK = 4        # frames made together: bounds the float32 temporaries (4 x 400 MB at 4K)


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (any whole number)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    return gen


def _block(n: int, height: int, width: int, gen: torch.Generator, device) -> torch.Tensor:
    """n frames as float32[n, 3, height, width] in [0, 255]."""
    coarse = torch.rand((n, 3, *GRID), generator=gen, device=device)
    img = F.interpolate(coarse, size=(height, width), mode="bicubic", align_corners=False)
    img = 40.0 + 170.0 * img.clamp(0.0, 1.0)
    ys = torch.arange(height, device=device, dtype=torch.float32).view(1, 1, height, 1)
    xs = torch.arange(width, device=device, dtype=torch.float32).view(1, 1, 1, width)
    # Per shape: centre (y, x), half sizes (y, x), colour (3), kind.
    params = torch.rand((SHAPES, n, 8), generator=gen, device=device)
    for p in params:
        cy, cx = p[:, 0] * height, p[:, 1] * width
        ry = (0.04 + 0.2 * p[:, 2]) * height
        rx = (0.04 + 0.2 * p[:, 3]) * width
        dy = (ys - cy.view(n, 1, 1, 1)).abs() / ry.view(n, 1, 1, 1)
        dx = (xs - cx.view(n, 1, 1, 1)).abs() / rx.view(n, 1, 1, 1)
        ellipse = (p[:, 7] < 0.5).view(n, 1, 1, 1)
        inside = torch.where(ellipse, dy * dy + dx * dx <= 1.0, torch.maximum(dy, dx) <= 1.0)
        img = torch.where(inside, 255.0 * p[:, 4:7].reshape(n, 3, 1, 1), img)
    noise = torch.randn((n, 3, height, width), generator=gen, device=device)
    return (img + NOISE * noise).clamp(0.0, 255.0)


def frames(n: int, height: int, width: int, seed: int, device) -> torch.Tensor:
    """uint8[n, height, width, 3] on ``device``, the same for the same
    arguments; made in blocks of ``BLOCK`` frames from one generator."""
    gen = generator(seed, device)
    out = torch.empty((n, height, width, 3), dtype=torch.uint8, device=device)
    for start in range(0, n, BLOCK):
        stop = min(n, start + BLOCK)
        block = _block(stop - start, height, width, gen, device)
        out[start:stop] = torch.floor(block + 0.5).to(torch.uint8).permute(0, 2, 3, 1)
    return out
