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
device (a peer copy between cards; nothing where the rows are already one
view there, as the bands of one upload are, ``shard_rows``). A stencil's
halo, a resize pass's tap window and a rotation's source window are all
such windows:

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

Compiled dispatch, the counterpart of the JAX module's ``jax.jit(shard_map
(...))`` kept per (shape, mesh): a band task (``"fused"``, a preset name, a
``PipelineConfig``, or a tuple of these, a fan-out) over an image on a mesh
whose every device is one card is one CUDA graph on that card
(``band_outputs``), kept per (task, image shape, dtype, mesh) in the byte
bound of all graphs (``utils/graphs.py``). Its static input is the whole
image, copied in from where it lies (the host, or a card); its bands are
views of that input; the halo windows, the histogram sum and the LUT are
inside the graph. A mesh over several cards, or the CPU, runs the same band
code eagerly (no graph spans two cards; the choice is made from the mesh
before anything runs, never after a failure), and so do calls given bands
(``list[Band]``) or made inside a capture, which the outer graph captures.

Memory: a graph keeps its pool, so a giant image's intermediates stay on
the card while the graph is kept. ``serve --spatial``'s fan-out of the four
presets over uint8[16384, 16384, 3] in one band holds 13,692,305,408 bytes
on an NVIDIA H100 (``chip_smoke.py`` phase 7 prints it): the 805 MB input,
the outputs, and the pool of every intermediate, the largest print_ready's
int32 dither planes (3.2 GB for the RGB image as int32, 1.1 GB for each
plane of the sum, the average and the thresholds). That is more than
``graphs.GRAPH_BYTES_BOUND``, so such a graph is kept alone; the fused
pipeline in 4 bands holds 1,352,663,040 bytes there.

Bands start on multiples of 4, so the Bayer phase ``y % 4`` of the dither
holds in every band. The JAX module's divisor sub-meshes and GSPMD
fallbacks have no counterpart: any height takes any mesh, and an image of
fewer rows than the mesh has bands of whole granules uses fewer bands.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
from typing import NamedTuple

import torch

from imageprocessingtools_tpu_torch import ops
from imageprocessingtools_tpu_torch.kernels import core
from imageprocessingtools_tpu_torch.kernels import resize as _k9
from imageprocessingtools_tpu_torch.kernels import rotate as _k1
from imageprocessingtools_tpu_torch.models.presets import THUMBNAIL_WIDTH, get_preset
from imageprocessingtools_tpu_torch.ops import _exact
from imageprocessingtools_tpu_torch.ops.histogram import _equalize_lut
from imageprocessingtools_tpu_torch.ops.packing import pack_bits_device
from imageprocessingtools_tpu_torch.parallel.batch import default_mesh, on_device
from imageprocessingtools_tpu_torch.pipeline import PipelineConfig
from imageprocessingtools_tpu_torch.utils import graphs

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
    """Split ``img`` (numpy or torch, uint8[H, W(, C)]) into bands, band k on
    ``mesh[k]``. The rows of each run of consecutive bands on one device (a
    card's bands, in a mesh from ``default_mesh``) move there in one copy,
    and its bands are views of that copy (of ``img`` itself where it lies
    there already)."""
    img, mesh = torch.as_tensor(img), default_mesh(mesh)
    bands = []
    spans = zip(split_rows(img.shape[0], len(mesh)), mesh)
    for dev, run in itertools.groupby(spans, key=lambda span: span[1]):
        rows = [r for r, _ in run]
        base = rows[0][0]
        moved = img[base:rows[-1][1]].to(dev)
        bands += [Band(r0, moved[r0 - base:r1 - base]) for r0, r1 in rows]
    return bands


def _adjacent(parts: list[torch.Tensor]) -> bool:
    """Whether ``parts`` are consecutive rows of one storage, with the same
    strides and row shape, so that one view holds them all."""
    first = parts[0]
    storage, offset = first.untyped_storage().data_ptr(), first.storage_offset()
    for p in parts:
        if (p.untyped_storage().data_ptr() != storage or p.storage_offset() != offset
                or p.stride() != first.stride() or p.shape[1:] != first.shape[1:]):
            return False
        offset += p.shape[0] * p.stride(0)
    return True


def row_window(bands: list[Band], lo: int, hi: int, device: torch.device,
               cols: tuple | None = None) -> torch.Tensor:
    """Global rows [lo, hi) (only columns [cols[0], cols[1]) if given),
    gathered from the bands that own them, on ``device``. Where the parts
    lie on ``device`` already, one part (with or without ``cols``), or,
    without ``cols``, parts that are consecutive rows of one storage with
    the same strides (the bands of one upload, ``shard_rows``), the window
    is a view and copies nothing; otherwise the parts are joined there by
    ``torch.cat``. A view is safe: nothing in this module writes into a
    band's data in place, every stage makes new tensors."""
    (device,) = default_mesh([device])
    parts = []
    for b in bands:
        a, z = max(lo, b.row0), min(hi, b.row0 + b.data.shape[0])
        if a < z:
            part = b.data[a - b.row0:z - b.row0]
            parts.append(part if cols is None else part[:, cols[0]:cols[1]])
    if sum(p.shape[0] for p in parts) != hi - lo or hi <= lo:
        raise ValueError(f"row_window: the bands do not hold rows [{lo}, {hi})")
    if len(parts) == 1:
        return parts[0].to(device)
    if cols is None and all(p.device == device for p in parts) and _adjacent(parts):
        first = parts[0]
        return first.as_strided((hi - lo,) + tuple(first.shape[1:]), first.stride(),
                                first.storage_offset())
    return torch.cat([p.to(device) for p in parts])


def gather(bands: list[Band], device="cpu") -> torch.Tensor:
    """The whole image of ``bands``, joined on ``device``."""
    return row_window(bands, 0, _height(bands), device).contiguous()


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


def _preset(bands: list[Band], name: str, mesh: tuple) -> list[Band]:
    if name == "thumbnail":
        return _resize(bands, THUMBNAIL_WIDTH, mesh)
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


@graphs.device_table(maxsize=32)
def _resize_plan(height: int, width: int, new_width: int, mesh: tuple):
    """The H pass of ``resize_width`` split into output bands, band k on
    ``mesh[k]``: [(o0, o1, lo, hi, idx, w), ...], rows [o0, o1) of the
    pass's tables with their indices less lo, the lowest source row they
    read. The window is checked on the host copy of the indices. Captured
    K9 launches read the sub-tables by pointer, so a capture holds them."""
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


def _resize(bands: list[Band], new_width: int, mesh: tuple) -> list[Band]:
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


def _rotate(bands: list[Band], angle: float, mesh: tuple) -> list[Band]:
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


def _pipeline(bands: list[Band], config: PipelineConfig, mesh: tuple) -> list[Band]:
    if config.new_width is not None:
        bands = _resize(bands, int(config.new_width), mesh)
    if config.angle is not None:
        bands = _rotate(bands, float(config.angle), mesh)
    if config.gray:
        bands = _map(ops.grayscale, bands)
    if config.mono:
        bands = _dither(bands)
    if config.flip_v:
        bands = _mirror(bands, (0,))
    if config.flip_h:
        bands = _map(ops.flip_horizontal, bands)
    return bands


def _element(item):
    """fn(bands, mesh) -> bands for one element of a band task (``"fused"``,
    a preset name or a PipelineConfig), checked before anything runs."""
    if isinstance(item, str) and item == "fused":
        return lambda bands, mesh: _equalize(_stencil(bands, 2, core.gray_gauss))
    if isinstance(item, str):
        get_preset(item)  # raises ValueError for unknown names
        return lambda bands, mesh: _preset(bands, item, mesh)
    if not item.any_op:  # quirk B2, as run_pipeline
        raise ValueError("Error: no data to write\n")
    return lambda bands, mesh: _pipeline(bands, item, mesh)


def _task_fn(task, pack: tuple = ()):
    """fn(bands, mesh) -> the task's bands (a tuple of them for a fan-out),
    each element whose ``pack`` flag is set packed to P4 rows per band
    (``pack_bits_device``)."""
    items = task if isinstance(task, tuple) else (task,)
    fns = [_element(item) for item in items]
    packs = tuple(pack) or (False,) * len(items)

    def run(bands, mesh):
        outs = []
        for fn, packed in zip(fns, packs):
            out = fn(bands, mesh)
            outs.append([Band(b.row0, pack_bits_device(b.data)) for b in out] if packed else out)
        return tuple(outs) if isinstance(task, tuple) else outs[0]

    return run


def _tag(task) -> str:
    if isinstance(task, tuple):
        return ";".join(_tag(item) for item in task)
    if isinstance(task, str):
        return task
    return ",".join(f"{k}={v}" for k, v in vars(task).items() if v not in (None, False))


def one_card(mesh: tuple) -> bool:
    """Whether a band pipeline over ``mesh`` (as ``default_mesh`` names it)
    runs as one CUDA graph: every band on one card (a pure function)."""
    return mesh[0].type == "cuda" and all(dev == mesh[0] for dev in mesh)


def graph_key(task, shape, dtype, mesh: tuple, pack: tuple = ()) -> tuple:
    """What a band graph is captured for: the task, which of its elements
    are packed (none: ``()``), the image's shape and dtype, and the mesh (a
    pure function)."""
    return (task, tuple(pack) if any(pack) else (), tuple(shape), dtype, tuple(mesh))


# graph_key -> utils.graphs._Entry, in the byte bound of all graphs
_band_graphs: collections.OrderedDict = collections.OrderedDict()


def band_body(task, mesh: tuple, pack: tuple = ()):
    """What a band graph captures: fn(image) -> ``task`` over the whole
    image in bands over ``mesh`` (views of the image where it lies on a
    band's device, ``shard_rows``). The task is checked here, before
    anything runs."""
    run = _task_fn(task, pack)

    def body(image):
        return run(shard_rows(image, mesh), mesh)

    body.__qualname__ = f"spatial {_tag(task)} on {len(mesh)} bands"
    return body


@contextlib.contextmanager
def band_outputs(task, img, mesh: tuple, pack: tuple = ()):
    """``task`` over ``img`` in bands over ``mesh``: (outputs, static) inside
    the block, the outputs a list of ``Band`` (a tuple of them for a
    fan-out; an element whose ``pack`` flag is set in P4 rows).

    ``img`` is numpy or a tensor, uint8[H, W(, C)], or bands. On a one-card
    mesh (``one_card``) the outputs are the static outputs of one replay of
    the task's graph (``static`` true), valid inside the block only: the
    graph's next call rewrites them. The image is copied from where it lies
    into the graph's input, and the first call of a (task, shape, dtype,
    mesh) captures the graph (``band_body``); a body that cannot be captured
    raises ``graphs.CaptureError``, and an allocation failure is raised as
    it is. Given bands, inside a capture, or over several cards or the CPU,
    the band code runs eagerly (``static`` false)."""
    mesh = default_mesh(mesh)
    if isinstance(img, list):
        yield _task_fn(task, pack)(img, mesh), False
        return
    body = band_body(task, mesh, pack)
    if not one_card(mesh) or graphs.capturing():
        yield body(img), False
        return
    x = torch.as_tensor(img)
    key = graph_key(task, x.shape, x.dtype, mesh, pack)
    with torch.cuda.device(mesh[0]), graphs.replayed(_band_graphs, key, body, x,
                                                     body.__qualname__) as outs:
        yield outs, True


def _fresh(outs):
    if isinstance(outs, tuple):
        return tuple(_fresh(o) for o in outs)
    return [Band(b.row0, b.data.clone()) for b in outs]


def band_pipeline(task, img, mesh: tuple, pack: tuple = ()):
    """``band_outputs`` as fresh bands that no later call rewrites, as a JAX
    executable returns fresh arrays (a replay's outputs are cloned)."""
    with band_outputs(task, img, mesh, pack) as (outs, static):
        return _fresh(outs) if static else outs


def fused_pipeline_spatial(img, mesh: tuple) -> list[Band]:
    """gray -> 5x5 Gaussian -> histogram equalization of one uint8[H, W, 3]
    in bands: K6 on each band's rows and 2 more each side, K4, the LUT, K3.
    Byte-equal to ``kernels.fused.fused_pipeline``. One CUDA graph on a
    one-card mesh (``band_outputs``)."""
    return band_pipeline("fused", img, mesh)


def preset_pipeline_spatial(img, name: str, mesh: tuple) -> list[Band]:
    """A ``models`` preset over one uint8[H, W, 3] in bands, byte-equal to
    the unsharded preset: ``edge_detect`` K6 and K7 Sobel on a window of 3
    rows each side; ``enhance`` K8, the banded equalization and K7 sharpen
    on a window of 1; ``print_ready`` K8, the equalization and the dither;
    ``thumbnail`` ``resize_width_spatial``. PBM outputs are 0/1 bytes. One
    CUDA graph on a one-card mesh (``band_outputs``)."""
    get_preset(name)  # raises ValueError for unknown names
    return band_pipeline(name, img, mesh)


def resize_width_spatial(img, new_width: int, mesh: tuple) -> list[Band]:
    """``ops.resize_width`` in bands, byte-equal: the W pass (K9) per band,
    the H pass (K9) per output band over the source rows its sub-table
    reads (``_resize_plan``). Either pass may come first, as the plan says
    (``device_passes`` raises the reference's B6/B7/B9 messages); the H
    pass's output bands are the new bands. One CUDA graph on a one-card
    mesh (``band_outputs``)."""
    return band_pipeline(PipelineConfig(new_width=int(new_width)), img, mesh)


def rotate_spatial(img, angle: float, mesh: tuple) -> list[Band]:
    """``ops.rotate`` in bands, byte-equal. 0/180 keep the bands (180 takes
    each band's mirror rows); 90/270 make output bands of column stripes of
    every source row; any other angle runs K1 per output band of 32-row
    tiles over its source window (``kernels/rotate.py::band_window``), and
    a band whose tiles are all outside the source is zeros. One CUDA graph
    on a one-card mesh (``band_outputs``)."""
    return band_pipeline(PipelineConfig(angle=float(angle)), img, mesh)


def run_pipeline_spatial(img, config, mesh: tuple) -> list[Band]:
    """``pipeline.run_pipeline`` in bands, in the reference's order:
    resize_width -> rotate -> gray -> mono -> flip_v -> flip_h. Each
    resampling stage makes new bands for its output. One CUDA graph on a
    one-card mesh (``band_outputs``)."""
    return band_pipeline(config, img, mesh)
