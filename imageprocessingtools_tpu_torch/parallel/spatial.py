"""One image in row bands over a mesh of devices.

Counterpart of ``imageprocessingtools_tpu/parallel/spatial.py``. The image
is split into bands of whole rows (``split_rows``), band k on ``mesh[k]``
(a mesh is a tuple of ``torch.device``, ``parallel.batch.default_mesh``; it
may name a device more than once). Every result is byte-identical to the
port's unsharded op, and so to the golden model.

The JAX module shards with ``shard_map``, moves halos by ``ppermute`` and
needs heights that divide the mesh, because XLA shards evenly and permutes
collectively. Here the one means of exchange is ``row_window``: the global
rows [lo, hi) gathered from the bands that own them and joined on one
device (a peer copy between cards, nothing when one band on that device
holds them). A stencil's halo, a resize pass's tap window and a rotation's
source window are all such windows:

- stencils (K6, K7) run on the band's rows plus their radius, clipped at
  the image's top and bottom, where the kernel's own replicate padding is
  the global one; the band's rows are then cropped out;
- the histogram (K4) counts each band's own rows, the counts are summed on
  the first band's device, the equalization LUT is made once from the
  whole image's pixel count and applied per band (K3);
- resize (K9) runs its W pass per band, and its H pass per output band
  from the sub-table of the band's output rows, rebased to the lowest
  source row they read: the taps and their order are the unsharded plan's;
- rotation (K1) runs per output band of 32-row tiles from the source rows
  that the band's tiles read (``kernels/rotate.py::band_window``); at 90
  and 270 degrees an output band is a column stripe of every source row.

Bands start on multiples of 4, so the Bayer phase ``y % 4`` of the dither
holds in every band. The JAX module's divisor sub-meshes and GSPMD
fallbacks have no counterpart: any height takes any mesh, and an image of
fewer rows than the mesh has bands of whole granules uses fewer bands.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from imageprocessingtools_tpu_torch import ops
from imageprocessingtools_tpu_torch.kernels import core
from imageprocessingtools_tpu_torch.kernels import resize as _k9
from imageprocessingtools_tpu_torch.kernels import rotate as _k1
from imageprocessingtools_tpu_torch.models.presets import THUMBNAIL_WIDTH, get_preset
from imageprocessingtools_tpu_torch.ops import _exact
from imageprocessingtools_tpu_torch.ops.histogram import _equalize_lut
from imageprocessingtools_tpu_torch.parallel.batch import default_mesh, on_device

GRANULE = 4  # band starts: the dither's Bayer period


class Band(NamedTuple):
    """Rows [row0, row0 + len(data)) of an image, on ``data.device``."""

    row0: int
    data: torch.Tensor


def split_rows(height: int, n: int, granule: int = GRANULE) -> list[tuple[int, int]]:
    """Near-equal bands [r0, r1) of ``height`` rows whose starts are
    multiples of ``granule``; fewer than ``n`` where the image has fewer
    than ``n`` granules."""
    units = -(-height // granule)
    n = max(1, min(n, units))
    starts = [granule * (k * units // n) for k in range(n)] + [height]
    return list(zip(starts[:-1], starts[1:]))


def _height(bands: list[Band]) -> int:
    return bands[-1].row0 + bands[-1].data.shape[0]


def shard_rows(img, mesh: tuple) -> list[Band]:
    """Split ``img`` (numpy or torch, uint8[H, W(, C)]) into bands, band k
    moved once to ``mesh[k]``."""
    img, mesh = torch.as_tensor(img), default_mesh(mesh)
    return [Band(r0, img[r0:r1].to(dev))
            for (r0, r1), dev in zip(split_rows(img.shape[0], len(mesh)), mesh)]


def row_window(bands: list[Band], lo: int, hi: int, device: torch.device,
               cols: tuple | None = None) -> torch.Tensor:
    """Global rows [lo, hi) (only columns [cols[0], cols[1]) if given),
    gathered from the bands that own them and joined on ``device``. One
    band on that device gives a view and copies nothing."""
    (device,) = default_mesh([device])
    parts = []
    for b in bands:
        a, z = max(lo, b.row0), min(hi, b.row0 + b.data.shape[0])
        if a < z:
            part = b.data[a - b.row0:z - b.row0]
            parts.append(part if cols is None else part[:, cols[0]:cols[1]])
    if sum(p.shape[0] for p in parts) != hi - lo or hi <= lo:
        raise ValueError(f"row_window: the bands do not hold rows [{lo}, {hi})")
    if len(parts) == 1 and parts[0].device == device:
        return parts[0]
    return torch.cat([p.to(device) for p in parts])


def gather(bands: list[Band], device="cpu") -> torch.Tensor:
    """The whole image of ``bands``, joined on ``device``."""
    return row_window(bands, 0, _height(bands), device).contiguous()


def _as_bands(img, mesh: tuple) -> tuple[list[Band], tuple]:
    """(bands, mesh): ``img`` as bands (bands stay as they are), and the
    mesh's devices as ``default_mesh`` names them."""
    mesh = default_mesh(mesh)
    return (img if isinstance(img, list) else shard_rows(img, mesh)), mesh


def _map(fn, bands: list[Band]) -> list[Band]:
    """``fn`` on each band's rows, on the band's device."""
    out = []
    for b in bands:
        with on_device(b.data.device):
            out.append(Band(b.row0, fn(b.data)))
    return out


def _mirror(bands: list[Band], dims: tuple) -> list[Band]:
    """The image's rows reversed (and ``dims`` flipped), in the same bands:
    output band [r0, r1) is source rows [H - r1, H - r0), flipped."""
    height = _height(bands)
    out = []
    for b in bands:
        dev = b.data.device
        with on_device(dev):
            window = row_window(bands, height - b.row0 - b.data.shape[0], height - b.row0, dev)
            out.append(Band(b.row0, window.flip(dims)))
    return out


def _stencil(bands: list[Band], radius: int, fn) -> list[Band]:
    """``fn`` (an op whose output row y reads input rows y - radius ..
    y + radius, with replicate edges) per band, on the band's rows and
    ``radius`` rows each side, clipped at the image's ends; then the band's
    own rows."""
    height = _height(bands)
    out = []
    for b in bands:
        r0, r1 = b.row0, b.row0 + b.data.shape[0]
        lo, hi = max(0, r0 - radius), min(height, r1 + radius)
        with on_device(b.data.device):
            res = fn(row_window(bands, lo, hi, b.data.device))
            out.append(Band(r0, res[r0 - lo:r1 - lo]))
    return out


def _equalize(bands: list[Band]) -> list[Band]:
    """Histogram equalization of a gray image in bands: K4 per band's own
    rows, the counts summed on the first band's device, one LUT from the
    whole image's pixel count, K3 per band."""
    n_pixels = _height(bands) * bands[0].data.shape[1]
    if n_pixels >= 2**31:  # as core._check_count, for the whole image
        raise ValueError("histogram requires < 2^31 total elements")
    home = bands[0].data.device
    hist = None
    for b in bands:
        with on_device(b.data.device):
            part = core.histogram(b.data).to(home)
        hist = part if hist is None else hist + part
    lut = _equalize_lut(hist, n_pixels)
    return _map(lambda v: core.lut_apply(v, lut.to(v.device)), bands)


def _dither(bands: list[Band]) -> list[Band]:
    """``ops.mono_dither`` per band: a band that starts on a multiple of 4
    has the global Bayer phase."""
    if any(b.row0 % 4 for b in bands):
        raise ValueError("mono in bands needs bands that start on multiples of 4")
    return _map(ops.mono_dither, bands)


def fused_pipeline_spatial(img, mesh: tuple) -> list[Band]:
    """gray -> 5x5 Gaussian -> histogram equalization of one uint8[H, W, 3]
    in bands: K6 on each band's rows and 2 more each side, K4, the LUT, K3.
    Byte-equal to ``kernels.fused.fused_pipeline``."""
    return _equalize(_stencil(_as_bands(img, mesh)[0], 2, core.gray_gauss))


def preset_pipeline_spatial(img, name: str, mesh: tuple) -> list[Band]:
    """A ``models`` preset over one uint8[H, W, 3] in bands, byte-equal to
    the unsharded preset: ``edge_detect`` K6 and K7 Sobel on a window of 3
    rows each side; ``enhance`` K8, the banded equalization and K7 sharpen
    on a window of 1; ``print_ready`` K8, the equalization and the dither;
    ``thumbnail`` ``resize_width_spatial``. PBM outputs are 0/1 bytes."""
    get_preset(name)  # raises ValueError for unknown names
    bands, mesh = _as_bands(img, mesh)
    if name == "thumbnail":
        return resize_width_spatial(bands, THUMBNAIL_WIDTH, mesh)
    if name == "edge_detect":
        return _stencil(bands, 3, lambda win: core.sobel(core.gray_gauss(win)))
    eq = _equalize(_map(ops.grayscale, bands))
    if name == "enhance":
        return _stencil(eq, 1, core.sharpen)
    return _dither(_map(lambda v: v[..., None].expand(v.shape + (3,)), eq))


def _pass_tables(height: int, width: int, new_width: int, dim: int, device: torch.device):
    """(idx, w) of ``resize_width``'s pass along ``dim`` on ``device``
    (``kernels/resize.py::device_passes``, cached there)."""
    (tables,) = [t[1:] for t in _k9.device_passes(height, width, new_width, device)
                 if t[0] == dim]
    return tables


@functools.lru_cache(maxsize=32)
def _resize_plan(height: int, width: int, new_width: int, mesh: tuple):
    """The H pass of ``resize_width`` split into output bands, band k on
    ``mesh[k]``: [(o0, o1, lo, hi, idx, w), ...], rows [o0, o1) of the
    pass's tables with their indices less lo, the lowest source row they
    read. The window is checked on the host copy of the indices."""
    (contrib,) = [c for dim, c in _exact.plan_resize(height, width, new_width).passes if dim == 0]
    bands = []
    for (o0, o1), dev in zip(split_rows(contrib.indices.shape[0], len(mesh)), mesh):
        rows = contrib.indices[o0:o1]
        lo, hi = int(rows.min()), int(rows.max()) + 1
        if lo < 0 or hi > height:
            raise RuntimeError(f"resize: rows [{o0}, {o1}) read [{lo}, {hi}) of {height}")
        idx, w = _pass_tables(height, width, new_width, 0, dev)
        bands.append((o0, o1, lo, hi, idx[o0:o1] - lo, w[o0:o1]))
    return bands


def resize_width_spatial(img, new_width: int, mesh: tuple) -> list[Band]:
    """``ops.resize_width`` in bands, byte-equal: the W pass (K9) per band,
    the H pass (K9) per output band over the source rows its sub-table
    reads (``_resize_plan``). Either pass may come first, as the plan says
    (``device_passes`` raises the reference's B6/B7/B9 messages); the H
    pass's output bands are the new bands."""
    bands, mesh = _as_bands(img, mesh)
    geometry = (_height(bands), bands[0].data.shape[1], int(new_width))
    for dim, *_ in _k9.device_passes(*geometry, mesh[0]):
        if dim == 1:
            bands = _map(lambda v: _k9.resize_pass(
                v.contiguous(), *_pass_tables(*geometry, 1, v.device), 1), bands)
            continue
        out = []
        for o0, _, lo, hi, idx, w in _resize_plan(*geometry, mesh):
            with on_device(idx.device):
                out.append(Band(o0, _k9.resize_pass(row_window(bands, lo, hi, idx.device),
                                                    idx, w, 0)))
        bands = out
    return bands


def rotate_spatial(img, angle: float, mesh: tuple) -> list[Band]:
    """``ops.rotate`` in bands, byte-equal. 0/180 keep the bands (180 takes
    each band's mirror rows); 90/270 make output bands of column stripes of
    every source row; any other angle runs K1 per output band of 32-row
    tiles over its source window (``kernels/rotate.py::band_window``), and
    a band whose tiles are all outside the source is zeros."""
    bands, mesh = _as_bands(img, mesh)
    angle = float(angle)
    height, width = _height(bands), bands[0].data.shape[1]
    if angle == 0.0:
        return bands
    if angle == 180.0:
        return _mirror(bands, (0, 1))
    out = []
    if angle in (90.0, 270.0):
        for (o0, o1), dev in zip(split_rows(width, len(mesh)), mesh):
            cols = (o0, o1) if angle == 90.0 else (width - o1, width - o0)
            turn = ops.rotate90 if angle == 90.0 else ops.rotate270
            with on_device(dev):
                out.append(Band(o0, turn(row_window(bands, 0, height, dev, cols))))
        return out
    new_h, new_w = _k1._geometry(height, width, angle)[:2]
    tail = tuple(bands[0].data.shape[2:])
    for (o0, o1), dev in zip(split_rows(new_h, len(mesh), _k1.TILE), mesh):
        window = _k1.band_window(height, width, angle, o0, o1)
        with on_device(dev):
            if window is None:
                data = torch.zeros((o1 - o0, new_w) + tail, dtype=torch.uint8, device=dev)
            else:
                src = row_window(bands, *window, dev).contiguous()
                data = _k1.rotate_bicubic(src, angle, height, window[0], (o0, o1))
            out.append(Band(o0, data))
    return out


def run_pipeline_spatial(img, config, mesh: tuple) -> list[Band]:
    """``pipeline.run_pipeline`` in bands, in the reference's order:
    resize_width -> rotate -> gray -> mono -> flip_v -> flip_h. Each
    resampling stage makes new bands for its output."""
    if not config.any_op:  # quirk B2, as run_pipeline
        raise ValueError("Error: no data to write\n")
    bands, mesh = _as_bands(img, mesh)
    if config.new_width is not None:
        bands = resize_width_spatial(bands, int(config.new_width), mesh)
    if config.angle is not None:
        bands = rotate_spatial(bands, float(config.angle), mesh)
    if config.gray:
        bands = _map(ops.grayscale, bands)
    if config.mono:
        bands = _dither(bands)
    if config.flip_v:
        bands = _mirror(bands, (0,))
    if config.flip_h:
        bands = _map(ops.flip_horizontal, bands)
    return bands

