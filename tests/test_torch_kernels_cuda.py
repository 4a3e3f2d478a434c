"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The plain versions are held to the JAX package and the golden
model by the CPU suites (tests/test_torch_rotate.py, test_torch_fused.py,
test_torch_stencil.py, test_torch_histogram.py, test_torch_gray_gauss.py,
test_torch_elementwise.py);
here each kernel must give the same bytes as its plain version on the same
CUDA tensors. Tolerance: none — every kernel is integer- or f64-exact (K8's contrast
is a table made by the plain chain's own f32 operations).

This file imports neither JAX nor tests/conftest.py, so it also runs on a
machine without JAX:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
"""

from __future__ import annotations

import collections
import importlib
import json

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu_torch.kernels import core, fused, rotate
from imageprocessingtools_tpu_torch.kernels import resize as k9

# ``from ...ops import resize`` would give the function the package exports.
resize_ops = importlib.import_module("imageprocessingtools_tpu_torch.ops.resize")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _image(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8))


# Shapes whose tiles are all mixed (small), or outside, interior and mixed
# (257x509), at the near-axis angles, 45 (the largest footprint) and others.
_ROTATE_ANGLES = (0.5, 30.0, 45.0, 89.5, 117.0, 179.9, 271.0, 359.5)


@pytest.mark.parametrize("shape,angle", [
    ((37, 53, 3), 117.0), ((48, 64, 3), 30.0), ((64, 48, 3), 135.0),
    ((16, 16), 45.0), ((29, 7), 333.3), ((1, 5, 3), 30.0), ((3, 3), 245.0),
    ((200, 160, 3), 1.0),
] + [(shape, angle) for shape in ((1, 1), (2, 3), (1, 1, 3), (2, 3, 3), (61, 97), (257, 509, 3))
     for angle in _ROTATE_ANGLES])
def test_rotate_kernel_matches_plain(cuda, shape, angle):
    img = _image(shape, seed=sum(shape)).to(cuda)
    before = rotate.rotate_bicubic.launches
    out = rotate.rotate_bicubic(img, angle)
    torch.cuda.synchronize()
    assert rotate.rotate_bicubic.launches == before + 1
    exp = rotate.rotate_plain(img, angle)
    assert out.shape == exp.shape and out.dtype == torch.uint8
    assert torch.equal(out, exp)


def _bands(new_h):
    """Output bands of a rotation with ``new_h`` rows: the top, a middle
    one, the bottom, one of an odd height and the whole image."""
    mid = new_h // 2 // rotate.TILE * rotate.TILE
    last = max(0, (new_h - 1) // rotate.TILE * rotate.TILE - rotate.TILE)
    return [(0, min(64, new_h)), (mid, min(new_h, mid + 96)), (last, new_h),
            (0, min(37, new_h)), (0, new_h)]


@pytest.mark.parametrize("angle", [30.0, 45.0, 135.0, 359.0])
@pytest.mark.parametrize("shape", [(257, 509, 3), (301, 203), (1080, 1920, 3), (70, 45, 1)])
@pytest.mark.parametrize("layout", ["copy", "view"])
def test_rotate_kernel_band_form(cuda, shape, angle, layout):
    """K1's band form: output rows [oy0, oy1) from the source window that
    ``band_window`` gives, on its own allocation or as a view into the whole
    image (the 16-byte chunks before the window's first byte are not read),
    equal to the plain band form and to the same rows of the full K1."""
    img = _image(shape, seed=sum(shape) + int(angle)).to(cuda)
    h, w = shape[:2]
    full = rotate.rotate_bicubic(img, angle)
    for oy0, oy1 in _bands(full.shape[0]):
        lo, hi = rotate.band_window(h, w, angle, oy0, oy1)
        src = img[lo:hi].clone() if layout == "copy" else img[lo:hi]
        before = rotate.rotate_bicubic.launches
        band = rotate.rotate_bicubic(src, angle, h, lo, (oy0, oy1))
        torch.cuda.synchronize()
        assert rotate.rotate_bicubic.launches == before + 1
        assert torch.equal(band, full[oy0:oy1]), (oy0, oy1)
        assert torch.equal(band, rotate.rotate_plain(src, angle, h, lo, (oy0, oy1)))


def test_rotate_kernel_band_form_refuses_a_short_window(cuda):
    img = _image((257, 509, 3), seed=3).to(cuda)
    lo, hi = rotate.band_window(257, 509, 30.0, 64, 128)
    before = rotate.rotate_bicubic.launches
    with pytest.raises(ValueError, match="outside the window"):
        rotate.rotate_bicubic(img[lo + 1:hi], 30.0, 257, lo + 1, (64, 128))
    assert rotate.rotate_bicubic.launches == before


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("shape,new_width", [((1080, 1920, 3), 256), ((97, 701, 3), 1400),
                                             ((48, 64), 21)])
def test_resize_sub_table_band_through_the_c_entry(cuda, n, shape, new_width):
    """The H pass of ``parallel/spatial.py``: each output band's sub-table,
    rebased to its window, through ``ipt_resize_pass``, gives the band's
    rows of the whole-image pass."""
    from imageprocessingtools_tpu_torch.kernels import _build
    from imageprocessingtools_tpu_torch.parallel import spatial

    img = _image(shape, seed=n).to(cuda)
    h, w = shape[:2]
    src = img
    before = collections.Counter(k9.cols_paths)
    for dim, idx, wts in k9.device_passes(h, w, new_width, cuda):
        if dim == 0:
            break
        src = k9.resize_pass(src, idx, wts, dim)  # the W pass first
    w_first = k9.device_passes(h, w, new_width, cuda)[0][0] == 1
    assert _cols_delta(before) == {"tiled": int(w_first), "gathered": 0}
    whole = k9.resize_pass(src, idx, wts, 0)
    for o0, o1, lo, hi, sub_idx, sub_w in spatial._resize_plan(h, w, new_width, (cuda,) * n):
        window = src[lo:hi]
        out = torch.empty((o1 - o0,) + tuple(src.shape[1:]), dtype=torch.uint8, device=cuda)
        _build.check(_build.library().ipt_resize_pass(
            *k9.launch_args(window, out, sub_idx, sub_w, 0)), "ipt_resize_pass")
        torch.cuda.synchronize()
        assert torch.equal(out, whole[o0:o1]), (o0, o1)
        assert torch.equal(out, k9.resize_pass_plain(window, sub_idx, sub_w, 0))


def _spatial_cases():
    from imageprocessingtools_tpu_torch.pipeline import PipelineConfig

    return ["fused", "edge_detect", "enhance", "print_ready", "thumbnail",
            PipelineConfig(new_width=300, angle=30.0, gray=True, mono=False, flip_v=True),
            PipelineConfig(angle=135.0, mono=True, flip_h=True), PipelineConfig(angle=90.0),
            PipelineConfig(angle=270.0, gray=True)]


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("case", _spatial_cases(), ids=str)
def test_spatial_paths_on_the_card_equal_the_unsharded_paths(cuda, n, case):
    """``parallel/spatial.py`` on a mesh that names the card n times, byte
    for byte the unsharded path on the card."""
    from imageprocessingtools_tpu_torch.models import PRESETS
    from imageprocessingtools_tpu_torch.parallel import spatial
    from imageprocessingtools_tpu_torch.pipeline import run_pipeline

    img = _image((203, 301, 3), seed=n).to(cuda)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = (dev,) * n
    if case == "fused":
        got, exp = spatial.fused_pipeline_spatial(img, mesh), fused.fused_pipeline_mega(img)
    elif isinstance(case, str):
        got, exp = spatial.preset_pipeline_spatial(img, case, mesh), PRESETS[case](img)
    else:
        got, exp = spatial.run_pipeline_spatial(img, case, mesh), run_pipeline(img, case)[0]
    assert all(b.data.device == dev for b in got)
    assert torch.equal(spatial.gather(got, dev), exp)


def test_spatial_and_batch_over_every_card(cuda):
    """Bands and batch shards on every card torch sees: the peer copies of
    ``row_window`` and each shard's upload."""
    from imageprocessingtools_tpu_torch.parallel import batch, spatial

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: copies between cards")
    mesh = batch.default_mesh()
    img = _image((517, 301, 3), seed=7)
    on_first = img.to(mesh[0])
    for got, exp in [
        (spatial.fused_pipeline_spatial(img, mesh), fused.fused_pipeline(on_first)),
        (spatial.rotate_spatial(img, 30.0, mesh), rotate.rotate_plain(on_first, 30.0)),
        (spatial.resize_width_spatial(img, 150, mesh), resize_ops.resize_width(on_first, 150)),
    ]:
        assert sorted({b.data.device.index for b in got}) == [d.index for d in mesh]
        assert torch.equal(spatial.gather(got, mesh[0]), exp)
    imgs = torch.stack([img] * len(mesh))
    shards = batch.batched_fused_pipeline(imgs, mesh=mesh)
    assert [s.device for s in shards] == list(mesh)
    assert torch.equal(batch.gather(shards, mesh[0])[-1], fused.fused_pipeline(on_first))


def _rgb(cuda, shape, kind, offset):
    """uint8[h, w, 3] on the card, as a contiguous view that starts ``offset``
    bytes into a larger buffer (1-15: K2/K6's unaligned rows). Kinds: noise,
    constant (one hot bin), white (the largest sums), checker (0/255, the
    rounding), gradient (a diagonal ramp over 0..255)."""
    h, w = shape
    if kind == "noise":
        img = _image((h, w, 3), seed=h * 1000 + w)
    elif kind in ("constant", "white"):
        img = torch.full((h, w, 3), 201 if kind == "constant" else 255, dtype=torch.uint8)
    else:
        ys, xs = torch.arange(h)[:, None], torch.arange(w)[None, :]
        g = ((ys + xs) % 2 * 255 if kind == "checker"
             else (ys + xs) * 255 // max(h + w - 2, 1)).to(torch.uint8)
        img = g[:, :, None].expand(h, w, 3)
    flat = torch.zeros(h * w * 3 + offset, dtype=torch.uint8, device=cuda)
    flat[offset:] = img.reshape(-1).to(cuda)
    view = flat[offset:].view(h, w, 3)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset % 16
    return view


# Widths whose 3W is not a multiple of 16 or whose last tile is ragged,
# heights 1-4 (the halo larger than the image), each at four offsets; the
# other kinds at a few shapes. The two largest have more tiles than the
# card holds blocks, so each block stages one tile while it computes another.
_GG_SHAPES = [(h, w) for h in (1, 2, 3, 4, 37) for w in (1, 2, 3, 4, 17, 130, 509, 3837, 4099)] + [
    (5, 17), (7, 53), (29, 130), (33, 129), (64, 300), (5, 3840), (70, 256), (1081, 4099),
    (2160, 3840)]
_GG_CASES = [(shape, "noise", offset) for shape in _GG_SHAPES for offset in (0, 1, 6, 15)] + [
    (shape, kind, offset) for kind in ("constant", "white", "checker", "gradient")
    for shape in ((2, 3), (37, 509), (64, 300), (5, 3840), (37, 4099)) for offset in (0, 5)]


@pytest.mark.parametrize("shape,kind,offset", _GG_CASES, ids=str)
def test_gray_gauss_hist_kernel_matches_plain(cuda, shape, kind, offset):
    img = _rgb(cuda, shape, kind, offset)
    before = core.gray_gauss_hist.launches
    blurred, hist = core.gray_gauss_hist(img)
    torch.cuda.synchronize()
    assert core.gray_gauss_hist.launches == before + 1
    exp_blurred, exp_hist = core.gray_gauss_hist_plain(img)
    assert torch.equal(blurred, exp_blurred)
    assert hist.dtype == torch.int32 and torch.equal(hist, exp_hist)
    assert int(hist.sum()) == shape[0] * shape[1]


@pytest.mark.parametrize("shape,kind,offset", _GG_CASES, ids=str)
def test_gray_gauss_kernel_matches_plain(cuda, shape, kind, offset):
    img = _rgb(cuda, shape, kind, offset)
    before = core.gray_gauss.launches
    out = core.gray_gauss(img)
    torch.cuda.synchronize()
    assert core.gray_gauss.launches == before + 1
    assert out.dtype == torch.uint8 and torch.equal(out, core.gray_gauss_plain(img))


def _gray(cuda, shape, kind, offset):
    """uint8[h, w] on the card: ``_rgb``'s red plane, as a contiguous view
    that starts ``offset`` bytes into a larger buffer (K5's unaligned rows)."""
    h, w = shape
    plane = _rgb(cuda, shape, kind, 0)[:, :, 0]
    flat = torch.zeros(h * w + offset, dtype=torch.uint8, device=cuda)
    flat[offset:] = plane.reshape(-1)
    view = flat[offset:].view(h, w)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset % 16
    return view


# K5 walks K2/K6's tiles on one byte per pixel: the same shapes, offsets and
# kinds (rows that are not 16-byte aligned, ragged last tiles, a halo larger
# than the image, more tiles than resident blocks).
@pytest.mark.parametrize("shape,kind,offset", _GG_CASES, ids=str)
def test_gaussian_blur_kernel_matches_plain(cuda, shape, kind, offset):
    img = _gray(cuda, shape, kind, offset)
    before = core.gaussian_blur.launches
    out = core.gaussian_blur(img)
    torch.cuda.synchronize()
    assert core.gaussian_blur.launches == before + 1
    assert out.dtype == torch.uint8 and torch.equal(out, core.gaussian_blur_plain(img))


_FULL_CHAIN = (("invert", 0), ("brightness", 30), ("contrast", 1.5), ("threshold", 128))
_CHAINS = [(), _FULL_CHAIN, (("invert", 0),), (("brightness", 30),), (("brightness", -40),),
           (("threshold", 128),)] + [(("contrast", f),) for f in (0.5, 1.37, 1.5, 2.0)]


def _all_grays(cuda, h, w):
    """uint8[h, w, 3] noise whose first 256 pixels are r=g=b=0..255."""
    img = _image((h, w, 3), seed=h * 7 + w)
    flat = img.view(-1, 3)
    flat[:256] = torch.arange(256, dtype=torch.uint8)[:, None]
    return img.to(cuda)


@pytest.mark.parametrize("layout", ["contiguous", "offset", "view"])
@pytest.mark.parametrize("shape", [(1, 1), (7, 53), (5, 3840), (16, 128), (37, 101)])
@pytest.mark.parametrize("chain", _CHAINS, ids=str)
def test_fused_elementwise_kernel_matches_plain(cuda, chain, shape, layout):
    h, w = shape
    img = _all_grays(cuda, h, w) if h * w >= 256 else _image((h, w, 3), seed=1).to(cuda)
    if layout == "offset":  # 1 pixel in: not 16-byte aligned, the byte-wise loop
        img = torch.cat([img.view(-1)[:3], img.view(-1)]).view(-1, 3)[1:].view(h, w, 3)
    elif layout == "view":  # every other column: the kernel gets it as ops.grayscale does
        img = torch.cat([img, img.flip(1)], dim=1)[:, ::2]
    exp = core.fused_elementwise_plain(img, chain)
    before = core.fused_elementwise.launches
    out = core.fused_elementwise(img.contiguous(), chain)
    torch.cuda.synchronize()
    assert core.fused_elementwise.launches == before + 1
    assert out.dtype == torch.uint8 and torch.equal(out, exp)


def test_grayscale_launches_k8_once(cuda):
    from imageprocessingtools_tpu_torch.ops.color import grayscale

    img = _image((9, 20, 3), seed=3).to(cuda)
    for src in (img, torch.cat([img, img], dim=1)[:, ::2], img[None]):
        before = core.fused_elementwise.launches
        out = grayscale(src)
        torch.cuda.synchronize()
        assert core.fused_elementwise.launches == before + 1
        assert torch.equal(out, core.grayscale_plain(src))


@pytest.mark.parametrize("n,offset", [(4096, 0), (1000, 0), (1000, 3), (7, 1)])
def test_lut_apply_kernel_matches_plain(cuda, n, offset):
    values = _image((n + offset,), seed=n)[offset:].to(cuda)
    lut = _image((256,), seed=n + 1).to(cuda)
    before = core.lut_apply.launches
    out = core.lut_apply(values, lut)
    torch.cuda.synchronize()
    assert core.lut_apply.launches == before + 1
    assert torch.equal(out, core.lut_apply_plain(values, lut))


def _check_histogram(values):
    before = core.histogram.launches
    hist = core.histogram(values)
    torch.cuda.synchronize()
    assert core.histogram.launches == before + 1
    assert hist.dtype == torch.int32 and torch.equal(hist, core.histogram_plain(values))
    assert int(hist.sum()) == values.numel()


@pytest.mark.parametrize("kind", ["noise", "constant", "offset"])
@pytest.mark.parametrize("shape", [(1, 1), (5, 17), (37, 53), (64, 300), (1, 4099)])
def test_histogram_kernel_matches_plain(cuda, shape, kind):
    img = _image(shape, seed=shape[0] * 31 + shape[1]).to(cuda)
    if kind == "constant":
        img.fill_(201)
    elif kind == "offset":  # an unaligned view: the bytes before the first 16-byte boundary
        img = _image((img.numel() + 1,), seed=shape[1]).to(cuda)[1:]
    _check_histogram(img)


def _values(cuda, n, kind, offset=0):
    """uint8[n] on the card as a view ``offset`` bytes into a buffer. Kinds:
    noise, constant (one bin, runs of 16 equal bytes), gradient (runs of
    equal bytes that end inside a 16-byte word), two (values 32 apart: one
    bank in a block-wide layout)."""
    if kind == "noise":
        v = _image((n,), seed=n % 9973 + offset)
    elif kind == "constant":
        v = torch.full((n,), 201, dtype=torch.uint8)
    elif kind == "gradient":
        v = (torch.arange(n) * 255 // max(n - 1, 1)).to(torch.uint8)
    else:
        v = (torch.arange(n) % 2 * 32 + 7).to(torch.uint8)
    flat = torch.zeros(n + offset, dtype=torch.uint8, device=cuda)
    flat[offset:] = v.to(cuda)
    view = flat[offset:]
    assert view.data_ptr() % 16 == offset % 16
    return view


@pytest.mark.parametrize("kind", ["noise", "constant", "gradient", "two"])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4099, 2160 * 3840])
def test_histogram_kernel_counts_every_size(cuda, n, kind):
    _check_histogram(_values(cuda, n, kind))


@pytest.mark.parametrize("kind", ["noise", "gradient"])
@pytest.mark.parametrize("n", [1, 17, 4099, 1 << 20])
@pytest.mark.parametrize("offset", range(1, 16))
def test_histogram_kernel_counts_unaligned_views(cuda, offset, n, kind):
    _check_histogram(_values(cuda, n, kind, offset))


def test_histogram_kernel_counts_a_large_constant_buffer(cuda):
    """2^26 + 5 equal bytes: one bin takes every count (a counter narrower
    than 32 bits would have to fold before it wraps), from a view 3 bytes in."""
    values = _values(cuda, (1 << 26) + 5, "constant", 3)
    _check_histogram(values)
    assert int(core.histogram(values)[201]) == values.numel()


def test_histogram_kernel_on_two_streams_at_once(cuda):
    """Calls on different streams run together; each stream has its own
    arrival words, so neither disturbs the other's counts."""
    inputs = [_values(cuda, 2160 * 3840, kind) for kind in ("noise", "gradient")]
    want = [core.histogram_plain(v) for v in inputs]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(25):
        for k, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                got[k].append(core.histogram(inputs[k]))
    torch.cuda.synchronize()
    for k in range(2):
        for hist in got[k]:
            assert torch.equal(hist, want[k])


def test_histogram_kernel_needs_no_zeroed_output(cuda):
    """Back-to-back calls reuse the allocator's block for the output: the
    launch stores every bin, whatever the block held."""
    values = _values(cuda, 4099, "two")
    for _ in range(3):
        hist = core.histogram(values)
        assert torch.equal(hist, core.histogram_plain(values))
        hist.fill_(-1)
        del hist


_STENCILS = [
    (core.gaussian_blur, core.gaussian_blur_plain),
    (core.box_blur, core.box_blur_plain),
    (core.sharpen, core.sharpen_plain),
    (core.sobel, core.sobel_plain),
]


@pytest.mark.parametrize("kind", ["noise", "edges"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (5, 1), (2, 3), (37, 53), (33, 129),
                                   (70, 300), (9, 4099), (130, 512), (65, 257)])
@pytest.mark.parametrize("wrapper,plain", _STENCILS, ids=lambda f: f.__name__)
def test_stencil_kernels_match_plain(cuda, wrapper, plain, shape, kind):
    img = _image(shape, seed=shape[0] * 131 + shape[1]).to(cuda)
    if kind == "edges":  # 0/255 steps reach the clip and Sobel's largest m
        img = (img > 127).to(torch.uint8) * 255
    before = wrapper.launches
    out = wrapper(img)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert out.dtype == torch.uint8 and torch.equal(out, plain(img))


@pytest.mark.parametrize("offset", [1, 5])
@pytest.mark.parametrize("wrapper,plain", _STENCILS[1:], ids=lambda f: f.__name__)
def test_stencil3_kernels_match_plain_on_unaligned_views(cuda, wrapper, plain, offset):
    """A view that starts off a 16-byte boundary takes K7's unaligned path."""
    flat = _image((70 * 320 + offset,), seed=offset).to(cuda)
    img = flat[offset:].view(70, 320)
    assert img.data_ptr() % 16
    assert torch.equal(wrapper(img), plain(img))


def test_sobel_root_is_exact_for_every_m(cuda):
    """K7 Sobel's clipped root against ops/stencil.py::_isqrt_round, clipped
    to 255, for every m in [0, 2,080,800], the largest gx^2 + gy^2 (gx = gy
    = 4 * 255)."""
    from imageprocessingtools_tpu_torch.kernels import _build
    from imageprocessingtools_tpu_torch.ops import stencil

    n = 2 * (4 * 255) ** 2 + 1
    out = torch.empty(n, dtype=torch.int32, device=cuda)
    _build.check(_build.library().ipt_sobel_out_test(
        out.data_ptr(), n, out.device.index, torch.cuda.current_stream(cuda).cuda_stream),
        "ipt_sobel_out_test")
    m = torch.arange(n, dtype=torch.int32)
    assert torch.equal(out.cpu(), stencil._isqrt_round(m).clamp(max=255))


def _resize_plain(img, target):
    """The two passes of a resize through K9's plain version (no launch)."""
    out = img
    for dim, idx, w in k9.device_passes(img.shape[0], img.shape[1], target, img.device):
        out = k9.resize_pass_plain(out, idx, w, dim)
    return out


def _check_resize(img, target):
    before = k9.resize_pass.launches
    if isinstance(target, tuple):
        out = resize_ops.resize(img, *target)
    else:
        out = resize_ops.resize_width(img, target)
    torch.cuda.synchronize()
    assert k9.resize_pass.launches == before + 2
    exp = _resize_plain(img, target)
    assert out.dtype == torch.uint8 and out.shape == exp.shape and out.is_contiguous()
    assert torch.equal(out, exp)


# Down- and upscales, RGB and 2-D gray, rows that are and are not 4-byte
# aligned, fewer source pixels than taps (5x7 -> 2, 3x3 -> 40), one row, more
# taps than a staged chunk (40x400 -> 20: 82), more outputs and rows than one
# block, source columns that do not fit in shared memory (400x20000 -> 100) and
# that nearly fill it (2000x5000 gray -> 5: 4002 taps over all 5000 columns).
@pytest.mark.parametrize("shape,new_width", [
    ((48, 64, 3), 32), ((48, 64, 3), 100), ((37, 53, 3), 32), ((37, 53), 32), ((37, 53), 77),
    ((5, 7, 3), 2), ((3, 3, 3), 40), ((1, 64, 3), 128), ((1, 64), 128), ((64, 1, 3), 3),
    ((40, 400, 3), 20), ((40, 400), 20), ((400, 40, 3), 3), ((270, 480, 3), 240),
    ((270, 480), 241), ((1079, 1913, 3), 777), ((135, 240, 3), 480), ((400, 20000, 3), 100),
    ((400, 20000), 100), ((2000, 5000, 3), 5), ((2000, 5000), 5),
])
def test_resize_kernel_matches_plain(cuda, shape, new_width):
    _check_resize(_image(shape, seed=sum(shape) + new_width).to(cuda), new_width)


@pytest.mark.parametrize("shape,target", [
    ((40, 30, 3), (20, 90)), ((40, 30), (90, 20)), ((33, 47, 3), (33, 47)),
    ((400, 6, 3), (9, 300)), ((6, 400), (300, 9)), ((9, 9, 3), (1, 1)),
])
def test_resize_to_explicit_shape_kernel_matches_plain(cuda, shape, target):
    _check_resize(_image(shape, seed=sum(shape) + sum(target)).to(cuda), target)


@pytest.mark.parametrize("seed", range(40))
def test_resize_kernel_matches_plain_on_random_geometries(cuda, seed):
    """A seeded sweep: heights and widths 1-300, 1 or 3 channels or 2-D, a
    target width from a 20th to 4 times the width (those whose height
    truncates to 0 raise on both sides and are drawn again)."""
    rng = np.random.default_rng(1000 + seed)
    while True:
        h, w = (int(v) for v in rng.integers(1, 301, size=2))
        new_width = max(1, int(w * float(rng.choice([0.05, 0.3, 0.5, 0.9, 1.0, 1.7, 4.0]))))
        if h * new_width >= w:
            break
    shape = [(h, w), (h, w, 1), (h, w, 3)][int(rng.integers(0, 3))]
    _check_resize(torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)).to(cuda),
                  new_width)


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_resize_pass_kernel_on_unaligned_views(cuda, offset, dim):
    """A view that starts off a 4-byte boundary: dim 0 takes its byte loads."""
    h, w = 36, 48
    flat = _image((h * w * 3 + offset,), seed=offset).to(cuda)
    img = flat[offset:].view(h, w, 3)
    assert img.is_contiguous() and img.data_ptr() % 4 == offset
    _, idx, wts = k9.device_passes(h, w, (18, 24), cuda)[1 - dim]
    assert torch.equal(k9.resize_pass(img, idx, wts, dim),
                       k9.resize_pass_plain(img, idx, wts, dim))


def test_resize_pass_kernel_keeps_the_tables_order(cuda):
    """Taps that only the order of the sum tells apart, on equal pixels of
    200: weights (2^60, 1, -2^60) lose the middle term (the sum is 0), and
    (2^60, -2^60, 1) keep it (200). Repeated and backwards indices are taken
    as they are."""
    img = torch.full((3, 200, 3), 200, dtype=torch.uint8, device=cuda)
    idx = torch.tensor([[2, 1, 0, 0], [0, 0, 1, 2]], dtype=torch.int32, device=cuda)
    big = 2.0 ** 60
    wts = torch.tensor([[big, 1.0, -big, 0.0], [big, -big, 1.0, 0.0]],
                       dtype=torch.float64, device=cuda)
    for dim, src in ((0, img), (1, img.transpose(0, 1).contiguous())):
        out = k9.resize_pass(src, idx, wts, dim)
        assert torch.equal(out, k9.resize_pass_plain(src, idx, wts, dim))
        rows = out if dim == 0 else out.transpose(0, 1)
        assert int(rows[0].max()) == 0 and int(rows[1].min()) == 200


@pytest.mark.parametrize("rows", [1, 5, 37])
def test_resize_pass_kernel_on_negative_weights_and_zero_bytes(cuda, rows):
    """The fused product gives +0.0 where a multiply gives -0.0 (b = 0 and a
    negative weight): rows of zeros, a zero column, and weights that are
    negative, -0.0, tiny and large, in both passes, each byte as the plain
    version's. The tables have 130 outputs: two blocks' worth in the W pass."""
    gen = np.random.default_rng(rows)
    out_size, taps = 130, 6
    img = _image((rows * 8, 40, 3), seed=rows)
    img[::3] = 0                               # whole rows of zero bytes
    img[:, 7] = 0
    idx = torch.from_numpy(gen.integers(0, 40, size=(out_size, taps), dtype=np.int32))
    w = gen.choice([-0.75, -0.0, 0.0, -1e-300, -2.5, 1.25, 3.0, 2.0 ** -40, -(2.0 ** 40)],
                   size=(out_size, taps))
    wts = torch.from_numpy(w)
    idx, wts = idx.to(cuda), wts.to(cuda)
    for dim, src in ((1, img), (0, img.transpose(0, 1).contiguous())):  # 40 source pixels
        src = src.to(cuda)
        out = k9.resize_pass(src, idx, wts, dim)
        torch.cuda.synchronize()
        assert torch.equal(out, k9.resize_pass_plain(src, idx, wts, dim))


@pytest.mark.parametrize("vec", [8, 4, 2, 1])
@pytest.mark.parametrize("offset", [0, 1, 2, 4])
def test_resize_rows_pass_at_every_bytes_per_thread(cuda, vec, offset):
    """The H pass at each bytes-per-thread choice the kernel takes (the
    wrapper picks one from the card's SMs, ``rows_vec``), on rows of 3 x 701
    bytes (not a multiple of 2) and of 3 x 704, at a view 0-4 bytes into its
    buffer: word loads where rows and buffers allow, byte loads elsewhere."""
    from imageprocessingtools_tpu_torch.kernels import _build

    for width in (701, 704):
        h = 97
        flat = _image((h * width * 3 + offset,), seed=vec + offset).to(cuda)
        img = flat[offset:].view(h, width, 3)
        _, idx, wts = k9.device_passes(h, width, (40, width), cuda)[0]
        out = torch.empty((40, width, 3), dtype=torch.uint8, device=cuda)
        _build.check(_build.library().ipt_resize_pass(*k9.launch_args(img, out, idx, wts, 0, vec)),
                     "ipt_resize_pass")
        torch.cuda.synchronize()
        assert torch.equal(out, k9.resize_pass_plain(img, idx, wts, 0))


def test_resize_pass_refuses_what_the_kernel_does_not_take(cuda):
    img = _image((8, 10, 3), seed=1).to(cuda)
    _, idx, wts = k9.device_passes(8, 10, 5, cuda)[0]
    with pytest.raises(TypeError):
        k9.resize_pass(img.transpose(0, 1), idx, wts, 0)  # not contiguous
    with pytest.raises(TypeError):
        k9.resize_pass(img[:, :, :2].contiguous(), idx, wts, 0)  # 1 or 3 channels
    with pytest.raises(TypeError):
        k9.resize_pass(img, idx.to(torch.int64), wts, 0)
    with pytest.raises(TypeError):
        k9.resize_pass(img, idx, wts.to(torch.float32), 0)
    with pytest.raises(TypeError):
        k9.resize_pass(img, idx.cpu(), wts.cpu(), 0)  # tables on another device
    with pytest.raises(ValueError):
        k9.resize_pass(img, idx, wts, 2)


# ---------------------------------------------------------------------------
# K9's W pass (csrc/resize.cu::pass_cols_kernel): lanes on rows, each group's
# tables staged once, tiles of rows by cp.async, the C host code's plan
# (csrc/cols_plan.cuh) counted by path in ``k9.cols_paths``.
# ---------------------------------------------------------------------------

def _cols_delta(before) -> dict:
    return {path: k9.cols_paths[path] - before[path] for path in ("tiled", "gathered")}


def _check_w_path(img, target, path):
    """``_check_resize`` (both passes byte-equal to the plain version), with
    its one W-pass launch on ``path``."""
    before = collections.Counter(k9.cols_paths)
    _check_resize(img, target)
    assert _cols_delta(before) == {"tiled": int(path == "tiled"),
                                   "gathered": int(path == "gathered")}


@pytest.mark.parametrize("target,argv", [(256, "thumbnail"), (1920, ["-w1920", "frame.ppm"])])
def test_w_pass_of_ten_4k_images_through_a_bound_replay(cuda, target, argv):
    """Ten 4K images through ``process_batch`` as the benchmark's resident
    cells make them: the capture launches the tiled W pass (counted there,
    never in a replay), and a later call on a copy of the group at a new
    address replays the graph with that input bound, byte-equal to the plain
    passes."""
    from imageprocessingtools_tpu_torch import cli, serving

    config = argv if isinstance(argv, str) else cli._parse_args(argv)[0]
    imgs = _image((10, 2160, 3840, 3), seed=target).to(cuda)
    before = collections.Counter(k9.cols_paths)
    first = serving.process_batch(imgs, config)[0]
    delta = _cols_delta(before)
    assert delta["tiled"] >= 1 and delta["gathered"] == 0
    moved = imgs.clone()
    assert moved.data_ptr() != imgs.data_ptr()
    before, counts = collections.Counter(k9.cols_paths), _plan_counts()
    out = serving.process_batch(moved, config)[0]
    assert _cols_delta(before) == {"tiled": 0, "gathered": 0}
    delta = _plan_delta(counts)
    assert delta["inputs_bound"] >= 1 and delta["copy_in_bytes"] == 0
    want = moved
    for dim, idx, w in k9.device_passes(2160, 3840, target, cuda):
        want = k9.resize_pass_batch_plain(want, idx, w, dim)
    torch.cuda.synchronize()
    assert out.shape == want.shape and torch.equal(out, want) and torch.equal(first, want)


@pytest.mark.parametrize("shape,target,path", [
    ((1080, 1920, 3), 3840, "tiled"),       # an upscale, 4 taps
    ((2160, 3840), 1920, "tiled"),          # gray
    ((1079, 1913, 3), 777, "tiled"),        # rows and widths not a multiple of a tile's
    ((97, 701, 3), 333, "tiled"),
    ((33, 130), 129, "tiled"),
    ((2160, 3840, 3), 45, "gathered"),      # 85:1: the columns do not fit
    ((400, 20000, 3), 100, "gathered"),
    # the band cases of test_resize_sub_table_band_through_the_c_entry, whole
    ((1080, 1920, 3), 256, "tiled"), ((97, 701, 3), 1400, "tiled"), ((48, 64), 21, "tiled"),
], ids=str)
def test_w_pass_path_and_bytes(cuda, shape, target, path):
    _check_w_path(_image(shape, seed=sum(shape) + target).to(cuda), target, path)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_w_pass_on_misaligned_source_and_output_views(cuda, offset):
    """A source view 1-3 bytes off a word boundary (through ``resize_pass``)
    and an output view as far off (through the C entry, as a graph's bind
    points a replay at a caller's buffers): the tiled path takes any address,
    byte-equal to the plain version."""
    from imageprocessingtools_tpu_torch.kernels import _build

    h, w, new_width = 135, 1001, 333
    flat = _image((h * w * 3 + offset,), seed=offset).to(cuda)
    img = flat[offset:].view(h, w, 3)
    assert img.data_ptr() % 4 == offset
    (idx, wts), = [t[1:] for t in k9.device_passes(h, w, new_width, cuda) if t[0] == 1]
    want = k9.resize_pass_plain(img, idx, wts, 1)
    before = collections.Counter(k9.cols_paths)
    assert torch.equal(k9.resize_pass(img, idx, wts, 1), want)
    assert _cols_delta(before) == {"tiled": 1, "gathered": 0}
    out_flat = torch.zeros(h * new_width * 3 + offset, dtype=torch.uint8, device=cuda)
    out = out_flat[offset:].view(h, new_width, 3)
    assert k9.cols_path(w, 3, new_width, idx.shape[1], img.device.index) == "tiled"
    _build.check(_build.library().ipt_resize_pass(*k9.launch_args(img, out, idx, wts, 1)),
                 "ipt_resize_pass")
    torch.cuda.synchronize()
    assert torch.equal(out, want) and int(out_flat[:offset].max()) == 0


@pytest.mark.parametrize("n", [1, 3])
def test_w_pass_groups_that_reach_past_a_staged_row_gather(cuda, n):
    """Tables that are not the reference's: a few outputs of 4K -> 1920 also
    reach column 0 and the last column, so their groups' columns are wider
    than the plan's staged rows (planned from the shape: tiled). Those groups
    read their pixels and tables from global memory inside the tiled launch,
    the others stage theirs; every byte equals the plain version's."""
    h, w, new_width = 75, 3840, 1920
    (idx, wts), = [t[1:] for t in k9.device_passes(h, w, new_width, cuda) if t[0] == 1]
    idx = idx.clone()
    for o in (5, 700, 1919):  # in the first, a middle and the last group
        idx[o, 0], idx[o, -1] = w - 1, 0
    imgs = _image((n, h, w, 3), seed=n).to(cuda)
    assert k9.cols_path(w, 3, new_width, idx.shape[1], imgs.device.index) == "tiled"
    before = collections.Counter(k9.cols_paths)
    out = k9.resize_pass_batch(imgs, idx, wts, 1) if n > 1 else k9.resize_pass(imgs[0], idx, wts, 1)
    assert _cols_delta(before) == {"tiled": 1, "gathered": 0}
    want = k9.resize_pass_batch_plain(imgs, idx, wts, 1)
    torch.cuda.synchronize()
    assert torch.equal(out, want if n > 1 else want[0])


def test_fused_mega_matches_plain(cuda):
    img = _image((70, 150, 3), seed=5).to(cuda)
    out = fused.fused_pipeline_mega(img)
    torch.cuda.synchronize()
    assert torch.equal(out, fused.fused_pipeline(img))


def test_fused_staged_matches_plain(cuda):
    img = _image((70, 150, 3), seed=6).to(cuda)
    wrappers = (core.fused_elementwise, core.gaussian_blur, core.histogram, core.lut_apply)
    counts = [w.launches for w in wrappers]
    out = fused.fused_pipeline_staged(img)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [n + 1 for n in counts]
    assert torch.equal(out, fused.fused_pipeline(img))


def test_plain_versions_launch_no_kernel(cuda):
    img = _image((40, 60, 3), seed=7).to(cuda)
    wrappers = (core.gray_gauss_hist, core.gray_gauss, core.fused_elementwise, core.lut_apply,
                core.histogram, core.gaussian_blur, core.box_blur, core.sharpen, core.sobel)
    before = [w.launches for w in wrappers]
    gray = img[:, :, 0].contiguous()
    fused.fused_pipeline(img)
    core.gray_gauss_hist_plain(img)
    core.gray_gauss_plain(img)
    core.grayscale_plain(img)
    core.fused_elementwise_plain(img, _FULL_CHAIN)
    for _, plain in _STENCILS:
        plain(gray)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == before


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    img = _image((8, 10, 3), seed=1).to(cuda)
    with pytest.raises(TypeError):
        rotate.rotate_bicubic(img.transpose(0, 1), 30.0)
    with pytest.raises(TypeError):
        rotate.rotate_bicubic(img[:, :, :2].contiguous(), 30.0)  # 1 or 3 channels
    with pytest.raises(TypeError):
        core.gray_gauss_hist(img[:, :, :2].contiguous())
    with pytest.raises(TypeError):
        core.gray_gauss_hist(img.to(torch.int32))
    for wrapper in (core.gray_gauss, core.fused_elementwise):
        with pytest.raises(TypeError):
            wrapper(img[:, :, :2].contiguous())
        with pytest.raises(TypeError):
            wrapper(img.to(torch.int32))
        with pytest.raises(TypeError):
            wrapper(img.transpose(0, 1))  # not contiguous
    with pytest.raises(ValueError, match="unknown op"):
        core.fused_elementwise(img, (("solarize", 1),))
    with pytest.raises(TypeError):
        core.lut_apply(img[:, :, 0].contiguous(), torch.arange(256, device=cuda))
    with pytest.raises(TypeError):
        core.histogram(img.transpose(0, 1))
    for wrapper, _ in _STENCILS:
        with pytest.raises(TypeError):
            wrapper(img)  # HWC: the kernels take one gray plane
        with pytest.raises(TypeError):
            wrapper(img[:, :, 0])  # not contiguous


# ---------------------------------------------------------------------------
# The batch axis (K2/K6, K4, K3 and K7 over uint8[N, ...] in one launch):
# each batched kernel against its plain batch version and against its
# single-image kernel image by image.
# ---------------------------------------------------------------------------


def _on_card(host: torch.Tensor, cuda, offset: int) -> torch.Tensor:
    """``host`` on the card as a contiguous view that starts ``offset``
    bytes into a larger buffer."""
    flat = torch.zeros(host.numel() + offset, dtype=torch.uint8, device=cuda)
    flat[offset:] = host.reshape(-1).to(cuda)
    view = flat[offset:].view(host.shape)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset % 16
    return view


def _rgb_batch(cuda, n, h, w, kind, offset):
    """uint8[n, h, w, 3] on the card: noise, constant images of n values, or
    noise and constant images in turn (``mixed``)."""
    imgs = _image((n, h, w, 3), seed=n * 7 + h * 1000 + w)
    if kind in ("constant", "mixed"):
        for i in range(0, n, 1 if kind == "constant" else 2):
            imgs[i] = 30 + 50 * i % 226
    return _on_card(imgs, cuda, offset)


# Batches of one, odd shapes (W % 16 != 0, H * W % 16 != 0, heights below
# the halo), more images than the card has SMs, and 4K: a block walks tiles
# of several images there.
_BATCH_SHAPES = [(1, 37, 53), (3, 37, 53), (2, 1, 1), (5, 2, 17), (4, 29, 130), (7, 5, 3840),
                 (3, 64, 256), (200, 16, 40), (64, 512, 512), (4, 2160, 3840)]
_BATCH_CASES = ([(shape, "noise", 0) for shape in _BATCH_SHAPES]
                + [(shape, kind, offset) for shape in ((3, 37, 53), (4, 29, 130), (64, 512, 512))
                   for kind, offset in (("noise", 5), ("constant", 0), ("mixed", 0),
                                        ("mixed", 11))])


@pytest.mark.parametrize("shape,kind,offset", _BATCH_CASES, ids=str)
def test_gray_gauss_batch_kernels_match_plain_and_the_single_kernel(cuda, shape, kind, offset):
    imgs = _rgb_batch(cuda, *shape, kind, offset)
    before = (core.gray_gauss_hist_batch.launches, core.gray_gauss_batch.launches)
    blurred, hist = core.gray_gauss_hist_batch(imgs)
    gray = core.gray_gauss_batch(imgs)
    torch.cuda.synchronize()
    assert (core.gray_gauss_hist_batch.launches,
            core.gray_gauss_batch.launches) == (before[0] + 1, before[1] + 1)
    exp_blurred, exp_hist = core.gray_gauss_hist_batch_plain(imgs)
    assert torch.equal(blurred, exp_blurred) and torch.equal(gray, exp_blurred)
    assert hist.dtype == torch.int32 and torch.equal(hist, exp_hist)
    assert (hist.sum(1) == shape[1] * shape[2]).all()
    for i in (0, shape[0] // 2, shape[0] - 1):
        one_blurred, one_hist = core.gray_gauss_hist(imgs[i])
        assert torch.equal(blurred[i], one_blurred) and torch.equal(hist[i], one_hist)


@pytest.mark.parametrize("shape,kind,offset", _BATCH_CASES, ids=str)
def test_histogram_and_lut_batch_kernels_match_plain_and_the_single_kernels(cuda, shape, kind,
                                                                            offset):
    values = _rgb_batch(cuda, *shape, kind, 0)[..., 1].contiguous()
    values = _on_card(values.cpu(), cuda, offset)
    luts = _image((shape[0], 256), seed=shape[0]).to(cuda)
    before = (core.histogram_batch.launches, core.lut_apply_batch.launches)
    hist = core.histogram_batch(values)
    out = core.lut_apply_batch(values, luts)
    torch.cuda.synchronize()
    assert (core.histogram_batch.launches,
            core.lut_apply_batch.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(hist, core.histogram_batch_plain(values))
    assert torch.equal(out, core.lut_apply_batch_plain(values, luts))
    for i in (0, shape[0] // 2, shape[0] - 1):
        assert torch.equal(hist[i], core.histogram(values[i]))
        assert torch.equal(out[i], core.lut_apply(values[i], luts[i]))


@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 4099])
@pytest.mark.parametrize("offset", [0, 3])
def test_histogram_and_lut_batch_kernels_at_every_image_length(cuda, n, offset):
    """Image lengths that are not multiples of 16: every image but the first
    starts off a 16-byte boundary, and the byte paths take its head and tail."""
    values = _on_card(_image((5, n), seed=n), cuda, offset)
    luts = _image((5, 256), seed=n + 1).to(cuda)
    assert torch.equal(core.histogram_batch(values), core.histogram_batch_plain(values))
    assert torch.equal(core.lut_apply_batch(values, luts),
                       core.lut_apply_batch_plain(values, luts))


def test_lut_apply_batch_kernel_on_an_output_off_the_inputs_alignment(cuda):
    values = _on_card(_image((3, 1000), seed=3), cuda, 1)
    luts = _image((3, 256), seed=4).to(cuda)
    out = core.lut_apply_batch(values, luts)
    assert torch.equal(out, core.lut_apply_batch_plain(values, luts))


def _every_value(w):
    """uint8[1, 1024, w]: each byte value on four rows and w columns, so at
    every position of the Bayer matrix for w >= 4."""
    return (torch.arange(1024) // 4).to(torch.uint8)[None, :, None].expand(1, 1024, w).contiguous()


# K10's cases: (host gray, bytes into its buffer on the card). 4K x 10 (the
# benchmark's group), rows of 26 bytes with 5 pad bits, H not a multiple of
# 4, W % 16 == 8 and rows shorter than a byte (the byte path), views one byte
# off alignment, and every byte value at every Bayer position.
_DITHER_CASES = {
    "10x2160x3840": (lambda: _image((10, 2160, 3840), seed=100), 0),
    "3x120x203": (lambda: _image((3, 120, 203), seed=101), 0),
    "3x120x203 at byte 1": (lambda: _image((3, 120, 203), seed=101), 1),
    "2x2160x3840 at byte 1": (lambda: _image((2, 2160, 3840), seed=102), 1),
    "2x5x16": (lambda: _image((2, 5, 16), seed=103), 0),
    "4x7x24": (lambda: _image((4, 7, 24), seed=104), 0),
    "3x3x5": (lambda: _image((3, 3, 5), seed=105), 0),
    "1x1x1": (lambda: _image((1, 1, 1), seed=106), 0),
    "every value 1x1024x16": (lambda: _every_value(16), 0),
    "every value 1x1024x13 at byte 1": (lambda: _every_value(13), 1),
}


@pytest.mark.parametrize("case", list(_DITHER_CASES))
def test_dither_pack_kernel_matches_plain(cuda, case):
    """K10 gives its plain version's bytes (the dither, then the packing, in
    torch ops) in one launch, with every pad bit 0."""
    host, offset = _DITHER_CASES[case]
    gray = _on_card(host(), cuda, offset)
    before = core.dither_pack_batch.launches
    out = core.dither_pack_batch(gray)
    torch.cuda.synchronize()
    assert core.dither_pack_batch.launches == before + 1
    n, h, w = gray.shape
    assert out.shape == (n, h, -(-w // 8)) and out.dtype == torch.uint8
    assert torch.equal(out, core.dither_pack_batch_plain(gray))


def test_dither_pack_kernel_refuses_what_it_does_not_take(cuda):
    gray = _image((2, 8, 32), seed=107).to(cuda)
    for bad in (gray.transpose(1, 2), gray.to(torch.int16), gray[0]):
        with pytest.raises(TypeError, match="dither_pack_batch"):
            core.dither_pack_batch(bad)


_STENCIL_BATCHES = [(core.box_blur_batch, core.box_blur), (core.sharpen_batch, core.sharpen),
                    (core.sobel_batch, core.sobel)]


@pytest.mark.parametrize("shape,kind,offset", _BATCH_CASES, ids=str)
@pytest.mark.parametrize("batch_wrapper,single", _STENCIL_BATCHES, ids=lambda f: f.__name__)
def test_stencil3_batch_kernels_match_plain_and_the_single_kernel(cuda, batch_wrapper, single,
                                                                  shape, kind, offset):
    gray = _on_card(_rgb_batch(cuda, *shape, kind, 0)[..., 2].cpu().contiguous(), cuda, offset)
    before = batch_wrapper.launches
    out = batch_wrapper(gray)
    torch.cuda.synchronize()
    assert batch_wrapper.launches == before + 1
    plain = {core.box_blur_batch: core.box_blur_batch_plain,
             core.sharpen_batch: core.sharpen_batch_plain,
             core.sobel_batch: core.sobel_batch_plain}[batch_wrapper]
    assert torch.equal(out, plain(gray))
    for i in (0, shape[0] // 2, shape[0] - 1):
        assert torch.equal(out[i], single(gray[i]))


def test_batch_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    imgs = _image((2, 8, 10, 3), seed=1).to(cuda)
    for wrapper in (core.gray_gauss_hist_batch, core.gray_gauss_batch):
        with pytest.raises(TypeError):
            wrapper(imgs[0])  # one image: the single-image wrapper's
        with pytest.raises(TypeError):
            wrapper(imgs.transpose(1, 2))
    gray = imgs[..., 0].contiguous()
    for wrapper, _ in _STENCIL_BATCHES:
        with pytest.raises(TypeError):
            wrapper(gray[0])
        with pytest.raises(TypeError):
            wrapper(imgs[..., 0])  # not contiguous
    with pytest.raises(TypeError):
        core.lut_apply_batch(gray, torch.zeros((3, 256), dtype=torch.uint8, device=cuda))
    with pytest.raises(TypeError):
        core.histogram_batch(gray.transpose(1, 2))


# K9 and K1 over a batch: the main paths' geometries at a smaller size
# (4K -> 1920: a half; 4K -> 256: a fifteenth; 1080p -> 3840: a double), odd
# widths, a batch of one, more images than the card has SMs, and views 5 and
# 11 bytes into their buffers (their rows off every word boundary).
_RESIZE_BATCHES = [((3, 540, 960, 3), 480, 0), ((2, 540, 960, 3), 64, 0),
                   ((2, 270, 480, 3), 960, 0), ((4, 540, 960), 480, 0), ((1, 37, 53, 3), 16, 0),
                   ((3, 37, 53, 3), 90, 5), ((200, 16, 40, 3), 24, 0), ((3, 29, 130), 77, 11),
                   ((5, 64, 64, 3), (31, 100), 5), ((2, 2160, 3840, 3), 1920, 0)]


@pytest.mark.parametrize("shape,target,offset", _RESIZE_BATCHES, ids=str)
def test_resize_pass_batch_kernel_matches_plain_and_the_single_kernel(cuda, shape, target,
                                                                      offset):
    imgs = _on_card(_image(shape, seed=sum(shape)), cuda, offset)
    tables = k9.device_passes(shape[1], shape[2], target, cuda)
    out, before = imgs, k9.resize_pass_batch.launches
    for dim, idx, w in tables:
        src, out = out, k9.resize_pass_batch(out, idx, w, dim)
        torch.cuda.synchronize()
        assert torch.equal(out, k9.resize_pass_batch_plain(src, idx, w, dim))
        for i in (0, shape[0] // 2, shape[0] - 1):
            assert torch.equal(out[i], k9.resize_pass(src[i].contiguous(), idx, w, dim))
    assert k9.resize_pass_batch.launches == before + 2
    again = (resize_ops.resize_batch(imgs, *target) if isinstance(target, tuple)
             else resize_ops.resize_width_batch(imgs, target))
    assert torch.equal(again, out)


@pytest.mark.parametrize("angle", [30.0, 135.0, 45.0, 0.5, 271.0])
@pytest.mark.parametrize("shape,offset", [((3, 257, 509, 3), 0), ((1, 37, 53, 3), 0),
                                          ((4, 61, 97), 0), ((3, 257, 509, 3), 5),
                                          ((70, 48, 64, 3), 11), ((2, 1080, 1920, 3), 0)],
                         ids=str)
def test_rotate_batch_kernel_matches_plain_and_the_single_kernel(cuda, shape, offset, angle):
    imgs = _on_card(_image(shape, seed=sum(shape)), cuda, offset)
    before = (rotate.rotate_bicubic_batch.launches, rotate.rotate_bicubic.launches)
    out = rotate.rotate_bicubic_batch(imgs, angle)
    torch.cuda.synchronize()
    assert (rotate.rotate_bicubic_batch.launches,
            rotate.rotate_bicubic.launches) == (before[0] + 1, before[1])
    assert torch.equal(out, rotate.rotate_batch_plain(imgs, angle))
    for i in (0, shape[0] // 2, shape[0] - 1):
        assert torch.equal(out[i], rotate.rotate_bicubic(imgs[i].contiguous(), angle))


def test_k1_and_k9_batch_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    imgs = _image((2, 8, 10, 3), seed=1).to(cuda)
    (dim, idx, w), _ = k9.device_passes(8, 10, 4, cuda)
    for bad in (imgs.transpose(1, 2), imgs[..., :2].contiguous(), imgs[0, 0]):
        with pytest.raises(TypeError):
            rotate.rotate_bicubic_batch(bad, 30.0)
        with pytest.raises(TypeError):
            k9.resize_pass_batch(bad, idx, w, dim)
    with pytest.raises(TypeError):
        k9.resize_pass_batch(imgs, idx.cpu(), w, dim)
    with pytest.raises(ValueError):
        k9.resize_pass_batch(imgs, idx, w, 2)


def _batch_form_task(label):
    from imageprocessingtools_tpu_torch import serving
    from imageprocessingtools_tpu_torch.pipeline import PipelineConfig

    if label == "mega":
        return fused.fused_pipeline_mega
    tasks = {"-w480 -r30 -gray": PipelineConfig(new_width=480, angle=30.0, gray=True),
             "-r135 -mono -fh": PipelineConfig(angle=135.0, mono=True, flip_h=True),
             "fanout thumbnail;-w480;-r30": ("thumbnail", PipelineConfig(new_width=480),
                                             PipelineConfig(angle=30.0))}
    return serving._task_fn(tasks.get(label, label))[0]


@pytest.mark.parametrize("label, launches", [
    ("mega", {"gray_gauss_hist_batch": 1, "lut_apply_batch": 1}),
    ("edge_detect", {"gray_gauss_batch": 1, "sobel_batch": 1}),
    ("enhance", {"fused_elementwise": 1, "histogram_batch": 1, "lut_apply_batch": 1,
                 "sharpen_batch": 1}),
    ("print_ready", {"fused_elementwise": 1, "histogram_batch": 1, "lut_apply_batch": 1,
                     "dither_pack_batch": 1}),
    ("thumbnail", {"resize_pass_batch": 2}),
    ("-w480 -r30 -gray", {"resize_pass_batch": 2, "rotate_bicubic_batch": 1,
                          "fused_elementwise": 1}),
    ("-r135 -mono -fh", {"rotate_bicubic_batch": 1}),
    ("fanout thumbnail;-w480;-r30", {"resize_pass_batch": 4, "rotate_bicubic_batch": 1}),
])
def test_a_batch_form_launches_each_kernel_once_per_group_under_capture(cuda, label, launches):
    """Five 540x960 images in groups of 2, 2 and 1: each replay credits one
    launch of each kernel of the batch form (a resize's two passes each) and
    none of a single-image one, and the outputs equal the per-image loop's.
    The graphs are dropped after."""
    from imageprocessingtools_tpu_torch import kernels
    from imageprocessingtools_tpu_torch.utils import graphs

    one = _batch_form_task(label)
    shape = (540, 960, 3)
    imgs = _host_batch(5, shape, seed=70)
    run = graphs.batched(one)
    old = graphs.GROUP_INPUT_BYTES
    graphs.GROUP_INPUT_BYTES = 2 * imgs[0].nbytes
    try:
        run(imgs, cuda)  # captures the 2-image and the 1-image graphs
        wrappers = {w.__name__: w for w in kernels.counted_wrappers()}
        before = {name: w.launches for name, w in wrappers.items()}
        got = run(imgs, cuda)
        torch.cuda.synchronize()
    finally:
        graphs.GROUP_INPUT_BYTES = old
        for key in [k for k in graphs._batch_graphs if k[0] is one and k[2] == shape]:
            graphs._batch_graphs.pop(key)
    made = {name: w.launches - before[name] for name, w in wrappers.items()
            if w.launches != before[name]}
    assert made == {name: 3 * n for name, n in launches.items()}  # three replays
    want = graphs.eager_batch(one, torch.from_numpy(imgs).to(cuda))
    for g, e in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        assert torch.equal(g, e)


# ---------------------------------------------------------------------------
# Images of 2^31 bytes and more: one launch each, offsets past 2^31 checked.
# ---------------------------------------------------------------------------

_BIG_RGB, _BIG_GRAY, _BOTTOM = (27000, 27000, 3), (46341, 46341), 64


def _card_noise(shape, seed):
    """uint8 noise made on the card (a 2 GB image is not made on the host)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)


@pytest.fixture(scope="module")
def big_rgb():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    img = _card_noise(_BIG_RGB, 31)
    yield img
    del img
    torch.cuda.empty_cache()


def test_rotate_takes_2_31_bytes(big_rgb):
    h, w, _ = _BIG_RGB
    out = rotate.rotate_bicubic(big_rgb, 30.0)
    new_h, new_w = out.shape[0], out.shape[1]
    for row0 in (new_h * 3 // 4 // rotate.TILE * rotate.TILE,
                 (new_h - _BOTTOM) // rotate.TILE * rotate.TILE):
        row1 = min(row0 + _BOTTOM, new_h)
        assert row0 * new_w * 3 >= 2**31
        lo, hi = rotate.band_window(h, w, 30.0, row0, row1)
        exp = rotate.rotate_plain(big_rgb[lo:hi], 30.0, height=h, src_row0=lo,
                                  out_rows=(row0, row1))
        assert torch.equal(out[row0:row1], exp)


@pytest.mark.parametrize("wrapper", [core.gray_gauss_hist, core.gray_gauss])
def test_gray_gauss_takes_2_31_bytes(big_rgb, wrapper):
    h = _BIG_RGB[0]
    assert (h - _BOTTOM - 2) * _BIG_RGB[1] * 3 >= 2**31
    out = wrapper(big_rgb)
    gray = out[0] if isinstance(out, tuple) else out
    exp = core.gray_gauss_plain(big_rgb[h - _BOTTOM - 2:])[2:]
    assert torch.equal(gray[h - _BOTTOM:], exp)
    if isinstance(out, tuple):
        assert torch.equal(out[1], torch.bincount(gray.reshape(-1), minlength=256).to(torch.int32))


@pytest.mark.parametrize("wrapper, plain, halo", [
    (core.gaussian_blur, core.gaussian_blur_plain, 2), (core.sobel, core.sobel_plain, 1),
    (core.box_blur, core.box_blur_plain, 1), (core.sharpen, core.sharpen_plain, 1)])
def test_gray_stencils_take_2_31_bytes(cuda, wrapper, plain, halo):
    h = _BIG_GRAY[0]
    img = _card_noise(_BIG_GRAY, 46341)
    assert img.numel() >= 2**31
    out = wrapper(img)
    assert torch.equal(out[h - _BOTTOM:], plain(img[h - _BOTTOM - halo:])[halo:])
    del img, out
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# utils/timing.py and utils/profiling.py on the card.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("body", ["mega", "staged", "histogram", "resize", "rotate"])
def test_device_loop_rate_on_the_card(cuda, body):
    from imageprocessingtools_tpu_torch.utils import device_loop_rate, dispatch_time

    img = _image((270, 480, 3), seed=7).to(cuda)
    fn = {"mega": fused.fused_pipeline_mega, "staged": fused.fused_pipeline_staged,
          "histogram": lambda x: core.histogram(x[:, :, 0].contiguous()).to(torch.uint8)[:240],
          "resize": lambda x: resize_ops.resize_width(x, 200),
          "rotate": lambda x: rotate.rotate_bicubic(x, 30.0)}[body]
    seen = []

    def watched(x):
        seen.append(x.device.type)
        return fn(x)

    sec = device_loop_rate(watched, img, iters=5, repeats=2)
    assert np.isfinite(sec) and sec > 0 and set(seen) == {"cuda"}
    assert np.isfinite(dispatch_time(fn, img, repeats=2))


def test_trace_to_holds_the_card_events(cuda, tmp_path):
    from imageprocessingtools_tpu_torch.profile_device import busy_us, device_events
    from imageprocessingtools_tpu_torch.utils.profiling import span, trace_to

    gray = _image((256, 512), seed=9).to(cuda)
    with trace_to(str(tmp_path)) as prof:
        with span("ipt-card-test"):
            core.sobel(gray)
    events = device_events(prof)
    assert any(e["cat"] == "kernel" and "stencil3" in e["name"] for e in events)
    assert busy_us(events) > 0
    with open(prof.chrome_trace) as f:
        trace = json.load(f)
    spans = [e for e in trace["traceEvents"] if e.get("cat") == "ipt_span"]
    assert [e["name"] for e in spans] == ["ipt-card-test"]
    # the kernel was launched inside the span, on the trace's one clock
    (sobel,) = [e for e in events if "stencil3" in e["name"]]
    assert spans[0]["ts"] <= sobel["ts"]


# ---------------------------------------------------------------------------
# CUDA graphs (utils/graphs.py): the flagship's compiled forms, the timing
# loop, K4 under capture.
# ---------------------------------------------------------------------------

_GRAPHED = {"mega": (fused.fused_gray_gauss_histeq_pallas_mega, fused.fused_pipeline_mega),
            "staged": (fused.fused_gray_gauss_histeq_pallas, fused.fused_pipeline_staged)}


@pytest.mark.parametrize("shape", [(2160, 3840, 3), (1081, 1927, 3)])
@pytest.mark.parametrize("form", list(_GRAPHED))
def test_graphed_flagship_equals_eager_and_plain(cuda, form, shape):
    from imageprocessingtools_tpu_torch.utils import graphs

    compiled, eager = _GRAPHED[form]
    g = graphs.graphed(eager)  # a fresh cache: the first call captures
    inputs = [_image(shape, seed=s).to(cuda) for s in (40, 41)]
    outs = []
    for x in inputs + inputs:
        out = g(x)
        assert torch.equal(out, eager(x)) and torch.equal(out, fused.fused_pipeline(x))
        outs.append(out)
    assert len(g._graphs) == 1
    static = g._graphs[graphs.graph_key(inputs[0])].captured.out
    assert all(o.data_ptr() != static.data_ptr() for o in outs)  # never the graph's buffer
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])
    assert not torch.equal(outs[0], outs[1])  # the first output survived the second call
    assert torch.equal(compiled(inputs[1]), outs[1])


def test_graphed_replays_credit_the_captured_launches(cuda):
    from imageprocessingtools_tpu_torch.utils import graphs

    x = _image((70, 150, 3), seed=5).to(cuda)
    g = graphs.graphed(fused.fused_pipeline_staged)
    g(x)  # capture: one warm-up call, then a replay
    wrappers = (core.fused_elementwise, core.gaussian_blur, core.histogram, core.lut_apply,
                core.gray_gauss_hist)
    before = [w.launches for w in wrappers]
    for _ in range(3):
        g(x)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [n + 3 for n in before[:4]] + before[4:]


def test_graphed_staged_forms_on_two_streams_at_once(cuda):
    """Two graphs of the staged form, two graphs of K4 alone and eager K4,
    interleaved on two streams: each captured K4 has arrival words of its
    own, so every histogram, and so every output, stays right."""
    from imageprocessingtools_tpu_torch.utils import graphs

    inputs = [_image((1080, 1920, 3), seed=s).to(cuda) for s in (50, 51)]
    grays = [core.grayscale_plain(x) for x in inputs]
    want = [fused.fused_pipeline(x) for x in inputs]
    want_hist = [core.histogram_plain(g) for g in grays]
    staged = [graphs.graphed(fused.fused_pipeline_staged) for _ in range(2)]
    hists = [graphs.graphed(core.histogram) for _ in range(2)]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    for k in range(2):  # captured before the race
        staged[k](inputs[k])
        hists[k](grays[k])
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(10):
        for k, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                got[k].append((staged[k](inputs[k]), hists[k](grays[k]),
                               core.histogram(grays[k])))
    torch.cuda.synchronize()
    for k in range(2):
        for out, hist, eager_hist in got[k]:
            assert torch.equal(out, want[k])
            assert torch.equal(hist, want_hist[k]) and torch.equal(eager_hist, want_hist[k])


def _uploads_a_table(x):
    """A body that uploads from the host on every call, as ``contrast`` and
    ``pack_bits_device`` did before their tables were cached per device."""
    return x + torch.tensor([1], dtype=x.dtype, device=x.device)


def test_capture_refuses_an_upload_from_the_host(cuda):
    import functools

    from imageprocessingtools_tpu_torch.ops.color import contrast
    from imageprocessingtools_tpu_torch.ops.packing import pack_bits_device
    from imageprocessingtools_tpu_torch.parallel import batch_apply
    from imageprocessingtools_tpu_torch.utils import device_loop_rate, graphs

    gray = _image((64, 96), seed=3).to(cuda)
    with pytest.raises(graphs.CaptureError, match="_uploads_a_table"):
        graphs.graphed(_uploads_a_table)(gray)
    with pytest.raises(graphs.CaptureError, match="batched\\(_uploads_a_table\\)"):
        batch_apply(_uploads_a_table, torch.stack([gray, gray]))
    with pytest.raises(graphs.CaptureError, match="device_loop_rate"):
        device_loop_rate(_uploads_a_table, gray, iters=2, repeats=1)
    # The card is still usable, and a capturable body still captures: since
    # their tables are made once per device, contrast and the packing too.
    assert torch.equal(graphs.graphed(core.sobel)(gray), core.sobel_plain(gray))
    factor = functools.partial(contrast, factor=1.5)
    assert torch.equal(graphs.graphed(factor)(gray), factor(gray))
    assert torch.equal(graphs.graphed(pack_bits_device)(gray & 1), pack_bits_device(gray & 1))


def test_device_loop_rate_times_the_card_for_mega(cuda):
    """At 4K the loop's time per iteration (mega and its feedback) lies
    within [0.8x, 2.5x] of mega's traced device time: the card's time, not
    the host's launch rate (host-launched, it read 10x)."""
    from imageprocessingtools_tpu_torch.profile_device import device_us_per_call
    from imageprocessingtools_tpu_torch.utils import device_loop_rate

    img = _image((2160, 3840, 3), seed=30).to(cuda)
    loop_us = device_loop_rate(fused.fused_pipeline_mega, img, iters=20, repeats=5,
                               stat="median") * 1e6
    traced_us = device_us_per_call("flagship mega", lambda: fused.fused_pipeline_mega(img))
    assert 0.8 * traced_us <= loop_us <= 2.5 * traced_us, (loop_us, traced_us)


def test_graph_cache_frees_its_graphs(cuda, monkeypatch):
    """Six graphs of equal pixel counts under a byte bound that holds four:
    the graphs kept stay within the bound, the memory the card holds for
    them with it, and dropping the callable frees them all."""
    from imageprocessingtools_tpu_torch.utils import graphs

    monkeypatch.setattr(graphs, "_held", collections.OrderedDict())  # other tests' graphs aside
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    g = graphs.graphed(fused.fused_pipeline_mega)
    shapes = [(384 * (k + 1), 393216 // (384 * (k + 1)), 3) for k in range(6)]
    held = []
    for i, shape in enumerate(shapes):
        out = g(_image(shape, seed=i).to(cuda))
        del out
        torch.cuda.synchronize()
        if i == 0:
            bound = int(4.5 * next(iter(g._graphs.values())).nbytes)
            monkeypatch.setattr(graphs, "GRAPH_BYTES_BOUND", bound)
        kept = graphs._live()
        assert sum(e.nbytes for e in kept) <= bound and len(kept) == len(g._graphs)
        held.append(torch.cuda.memory_allocated(cuda) - base)
        assert held[-1] <= bound, (i, held)
    assert 2 <= len(g._graphs) < len(shapes)  # the bound dropped some, not all
    del g, kept
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) - base <= 0.05 * bound


def _delta(before: dict) -> dict:
    from imageprocessingtools_tpu_torch.utils import graphs

    return {k: v - before[k] for k, v in graphs.counts().items()}


def test_batched_counts_its_capture_replays_and_uploads(cuda, monkeypatch):
    """One batched call from the host in two groups: one capture, a replay
    and an upload of each group's bytes, each under its span, and each
    group's outputs copied out; from the card, each group's input and output
    bound into the graph's kernels within its ``graphs.replay`` span,
    nothing uploaded or copied."""
    from imageprocessingtools_tpu_torch.utils import graphs, profiling

    imgs = _image((4, 96, 160, 3), seed=91).numpy()  # a shape no other test captures
    monkeypatch.setattr(graphs, "GROUP_INPUT_BYTES", 2 * imgs[0].nbytes)
    run = graphs.batched(fused.fused_pipeline_mega)
    before = graphs.counts()
    with profiling.recording() as rec:
        out = run(imgs, cuda)
    assert _delta(before) == {"graphs_captured": 1, "graphs_evicted": 0, "graph_replays": 2,
                              "upload_bytes": imgs.nbytes, "inputs_bound": 0,
                              "outputs_bound": 0, "copy_in_bytes": 0,
                              "copy_out_bytes": out.nbytes}
    names = collections.Counter(s.name for s in rec.spans)
    assert names == {"graphs.group": 2, "graphs.capture": 1, "graphs.upload": 2,
                     "graphs.replay": 2, "graphs.copy_out": 2}
    on_card = torch.from_numpy(imgs).to(cuda)
    before = graphs.counts()
    with profiling.recording() as rec:
        again = run(on_card, cuda)
    assert _delta(before) == {"graphs_captured": 0, "graphs_evicted": 0, "graph_replays": 2,
                              "upload_bytes": 0, "inputs_bound": 2, "outputs_bound": 2,
                              "copy_in_bytes": 0, "copy_out_bytes": 0}
    names = collections.Counter(s.name for s in rec.spans)
    assert names == {"graphs.group": 2, "graphs.replay": 2}
    want = torch.stack([fused.fused_pipeline_mega(on_card[i]) for i in range(4)])
    assert torch.equal(out, want) and torch.equal(again, want)


def test_graph_evictions_are_counted_under_a_span(cuda, monkeypatch):
    """Under a byte bound that no graph fits, each capture drops the graph
    before it: three captures, two evictions, each in a ``graphs.evict``
    span."""
    from imageprocessingtools_tpu_torch.utils import graphs, profiling

    monkeypatch.setattr(graphs, "_held", collections.OrderedDict())  # other tests' graphs aside
    monkeypatch.setattr(graphs, "GRAPH_BYTES_BOUND", 1)
    g = graphs.graphed(fused.fused_pipeline_mega)
    before = graphs.counts()
    with profiling.recording() as rec:
        for i, shape in enumerate([(64, 96, 3), (72, 96, 3), (80, 96, 3)]):
            g(_image(shape, seed=i).to(cuda))
    assert _delta(before) == {"graphs_captured": 3, "graphs_evicted": 2, "graph_replays": 3,
                              "upload_bytes": 0, "inputs_bound": 3, "outputs_bound": 3,
                              "copy_in_bytes": 0, "copy_out_bytes": 0}
    assert len(g._graphs) == 1
    assert [s.name for s in rec.spans].count("graphs.evict") == 2


# ---------------------------------------------------------------------------
# Bound inputs and outputs (utils/graphs.py::bindable): a group on the card is
# read and written where it lies, byte-equal to the per-image forms.
# ---------------------------------------------------------------------------

def _bound_tasks():
    """name -> (the batched callable's fn, the per-image form)."""
    from imageprocessingtools_tpu_torch import serving
    from imageprocessingtools_tpu_torch.models import presets

    thumbnail, _ = serving._task_fn("thumbnail")
    return {"flagship": (fused.fused_pipeline_mega, fused.fused_pipeline_mega),
            "thumbnail": (thumbnail, presets.PRESETS["thumbnail"])}


def _per_image(single, batch):
    return torch.stack([single(batch[i]) for i in range(batch.shape[0])])


def test_a_three_stage_reference_task_is_bound_and_plans_k1_once(cuda, monkeypatch):
    """``-w<N> -r30 -gray`` (K9's two passes, K1 and K8 in one graph) on
    groups on the card: every replay binds its group's input and output,
    the ``pipeline.<stage>`` spans run only in each capture's warm-up and
    capture, and K1's plan for the one geometry is made once."""
    from imageprocessingtools_tpu_torch import serving
    from imageprocessingtools_tpu_torch.kernels import rotate
    from imageprocessingtools_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from imageprocessingtools_tpu_torch.utils import graphs, profiling

    # a geometry no other test plans; 207 x 240 answers, so that every
    # group's rows start on the 16 bytes that K8 was chosen by
    config = PipelineConfig(new_width=208, angle=30, gray=True)
    fn, _ = serving._task_fn(config)
    batch = _image((5, 270, 470, 3), seed=101).to(cuda)
    monkeypatch.setattr(graphs, "GROUP_INPUT_BYTES", 2 * batch[0].nbytes)  # groups of 2, 2, 1
    run = graphs.batched(fn)
    before, plans = graphs.counts(), rotate.plans_made
    with profiling.recording() as rec:
        first = run(batch, cuda)
    assert _delta(before)["graphs_captured"] == 2 and rotate.plans_made == plans + 1
    names = collections.Counter(s.name for s in rec.spans)
    assert names["rotate.plan"] == 1
    for stage in ("pipeline.resize", "pipeline.rotate", "pipeline.gray"):
        assert names[stage] == 4  # two graphs, each warmed up and captured
    before = graphs.counts()
    with profiling.recording() as rec:
        again = run(batch, cuda)
    assert _delta(before) == {"graphs_captured": 0, "graphs_evicted": 0, "graph_replays": 3,
                              "upload_bytes": 0, "inputs_bound": 3, "outputs_bound": 3,
                              "copy_in_bytes": 0, "copy_out_bytes": 0}
    assert rotate.plans_made == plans + 1
    assert collections.Counter(s.name for s in rec.spans) == {
        "graphs.group": 3, "graphs.replay": 3}
    want = _per_image(lambda img: run_pipeline(img, config)[0], batch)
    assert torch.equal(first, want) and torch.equal(again, want)


def _misaligned(x):
    """A copy of ``x`` one byte past a 16-byte boundary."""
    buf = torch.empty(x.nbytes + 1, dtype=torch.uint8, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("task", ["flagship", "thumbnail"])
def test_bound_groups_equal_the_per_image_forms(cuda, monkeypatch, task):
    """Groups that are views of one batch on the card: every replay reads
    its group and writes its rows of the output where they lie (no copy in,
    no copy out), byte-equal to the per-image form."""
    from imageprocessingtools_tpu_torch.utils import graphs, profiling

    fn, single = _bound_tasks()[task]
    batch = _image((5, 270, 480, 3), seed=97).to(cuda)
    monkeypatch.setattr(graphs, "GROUP_INPUT_BYTES", 2 * batch[0].nbytes)  # groups of 2, 2, 1
    run = graphs.batched(fn)
    run(batch, cuda)  # the captures
    before = graphs.counts()
    with profiling.recording() as rec:
        out = run(batch, cuda)
    assert _delta(before) == {"graphs_captured": 0, "graphs_evicted": 0, "graph_replays": 3,
                              "upload_bytes": 0, "inputs_bound": 3, "outputs_bound": 3,
                              "copy_in_bytes": 0, "copy_out_bytes": 0}
    names = collections.Counter(s.name for s in rec.spans)
    assert names == {"graphs.group": 3, "graphs.replay": 3}
    assert torch.equal(out, _per_image(single, batch))


def test_bound_then_copied_then_bound_on_one_graph(cuda):
    """One graph: an aligned group is bound, a view one byte off the
    alignment K2 was captured with is copied in, and the next aligned group
    is bound again; every output byte-equal to the per-image form."""
    from imageprocessingtools_tpu_torch.utils import graphs

    run = graphs.batched(fused.fused_pipeline_mega)
    xs = [_image((3, 128, 256, 3), seed=s).to(cuda) for s in (71, 72, 73)]
    run(xs[0], cuda)  # the capture
    captures = graphs.captures_made
    inputs = [xs[0], _misaligned(xs[1]), xs[2]]
    for x, bound in zip(inputs, (True, False, True)):
        before = graphs.counts()
        out = run(x, cuda)
        delta = _delta(before)
        assert delta["inputs_bound"] == bound and delta["outputs_bound"] == 1
        assert delta["copy_in_bytes"] == (0 if bound else x.nbytes)
        assert torch.equal(out, _per_image(fused.fused_pipeline_mega, x))
    assert graphs.captures_made == captures


def test_bound_input_freed_and_reallocated_between_calls(cuda):
    """A bound input dropped after its call and another allocated (most
    likely where it lay): each call reads its own input's bytes."""
    from imageprocessingtools_tpu_torch.utils import graphs

    run = graphs.batched(fused.fused_pipeline_mega)
    outs, wants = [], []
    for seed in (81, 82, 83):
        x = _image((2, 96, 320, 3), seed=seed).to(cuda)
        outs.append(run(x, cuda))
        wants.append(_per_image(fused.fused_pipeline_mega, x))
        del x
    torch.cuda.synchronize()
    assert all(torch.equal(o, w) for o, w in zip(outs, wants))
    assert not torch.equal(outs[0], outs[1])


def test_bound_call_on_a_second_stream(cuda):
    """A bound call on a side stream: the input made on the default stream
    is read there, and the graph's next call on the default stream waits."""
    from imageprocessingtools_tpu_torch.utils import graphs

    run = graphs.batched(fused.fused_pipeline_mega)
    x = _image((2, 112, 224, 3), seed=85).to(cuda)
    want = _per_image(fused.fused_pipeline_mega, x)
    run(x, cuda)  # the capture, on the default stream
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = graphs.counts()
    with torch.cuda.stream(side):
        out = run(x, cuda)
        y = _image((2, 112, 224, 3), seed=86).to(cuda)
        out_y = run(y, cuda)
    torch.cuda.current_stream().wait_stream(side)
    again = run(x, cuda)
    torch.cuda.synchronize()
    assert _delta(before)["inputs_bound"] == 3
    assert torch.equal(out, want) and torch.equal(again, want)
    assert torch.equal(out_y, _per_image(fused.fused_pipeline_mega, y))


def test_print_ready_binds_its_input_and_its_output(cuda):
    """print_ready's packed rows are K10's output, written whole by one
    launch: a replay from the card reads its input and writes its output
    where they lie, nothing copied out of the graph; byte-equal to the
    per-image form."""
    from imageprocessingtools_tpu_torch import serving
    from imageprocessingtools_tpu_torch.utils import graphs, profiling

    one, _ = serving._task_fn("print_ready")
    run = graphs.batched(one)
    x = _image((3, 120, 203, 3), seed=87).to(cuda)  # rows of 26 bytes, 5 bits of padding
    run(x, cuda)  # the capture
    before = graphs.counts()
    with profiling.recording() as rec:
        out = run(x, cuda)
    delta = _delta(before)
    assert delta["inputs_bound"] == 1 and delta["outputs_bound"] == 1
    assert delta["copy_out_bytes"] == 0 and out.shape == (3, 120, 26)
    assert collections.Counter(s.name for s in rec.spans)["graphs.copy_out"] == 0
    assert torch.equal(out, graphs.eager_batch(one, x))


def test_graphed_flagship_binds_a_fresh_output(cuda):
    """``graphed`` on a card tensor: the input bound, the output written
    into a fresh tensor (never the graph's), as a clone of it would be."""
    from imageprocessingtools_tpu_torch.utils import graphs

    g = graphs.graphed(fused.fused_pipeline_mega)
    x, y = (_image((150, 256, 3), seed=s).to(cuda) for s in (88, 89))
    g(x)  # the capture
    before = graphs.counts()
    outs = [g(x), g(y), g(_misaligned(x))]
    delta = _delta(before)
    assert delta["inputs_bound"] == 2 and delta["outputs_bound"] == 3
    static = g._graphs[graphs.graph_key(x)].captured.out
    assert all(o.data_ptr() != static.data_ptr() for o in outs)
    want = fused.fused_pipeline_mega(x)
    assert torch.equal(outs[0], want) and torch.equal(outs[2], want)
    assert torch.equal(outs[1], fused.fused_pipeline_mega(y))


# ---------------------------------------------------------------------------
# Dispatch plans (utils/graphs.py::Batched, _Plan): the first call of a batch
# on the card makes the plan that it and every repeat call run, one native
# dispatch a bound group.
# ---------------------------------------------------------------------------

def _plan_counts() -> dict:
    from imageprocessingtools_tpu_torch.utils import graphs

    return {**graphs.counts(), "dispatch_plans_made": graphs.dispatch_plans_made,
            "dispatch_plan_hits": graphs.dispatch_plan_hits}


def _plan_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _plan_counts().items()}


def _resident_tasks():
    """name -> (a call on a group on the card as the benchmark makes it, the
    per-image form); shapes no other test takes."""
    from imageprocessingtools_tpu_torch import cli, serving
    from imageprocessingtools_tpu_torch.models import presets
    from imageprocessingtools_tpu_torch.parallel import batch
    from imageprocessingtools_tpu_torch.pipeline import run_pipeline

    config = cli._parse_args(["-w1920", "-r30", "-gray", "frame.ppm"])[0]
    return {
        "flagship": (batch.batched_fused_pipeline, fused.fused_pipeline_mega, (3, 200, 352, 3)),
        "thumbnail": (lambda g: serving.process_batch(g, "thumbnail")[0],
                      presets.PRESETS["thumbnail"], (3, 208, 352, 3)),
        "-w1920 -r30 -gray": (lambda g: serving.process_batch(g, config)[0],
                              lambda img: run_pipeline(img, config)[0], (2, 216, 384, 3)),
    }


@pytest.mark.parametrize("task", ["flagship", "thumbnail", "-w1920 -r30 -gray"])
def test_resident_calls_take_a_kept_plan(cuda, monkeypatch, task):
    """30 calls over three distinct groups on the card, as the benchmark's
    resident cells make them: the first call makes a plan and runs it,
    every later one takes it, every replay (the first call's too) binds its
    input and output, and every output kept to the end is byte-equal to the
    per-image form (no later call rewrites an earlier one's)."""
    from imageprocessingtools_tpu_torch.utils import graphs

    call, single, shape = _resident_tasks()[task]
    monkeypatch.setattr(graphs, "GROUP_INPUT_BYTES", 2 * int(np.prod(shape[1:])))  # 2 + 1
    groups = [_image(shape, seed=140 + k).to(cuda) for k in range(3)]
    before = _plan_counts()
    outs = [call(groups[k % 3]) for k in range(30)]
    delta = _plan_delta(before)
    replays = 30 * len(graphs.spans(shape[0], graphs.group_size(int(np.prod(shape[1:])))))
    assert delta["dispatch_plans_made"] == 1 and delta["dispatch_plan_hits"] == 29
    assert delta["graph_replays"] == replays
    assert delta["inputs_bound"] == replays and delta["outputs_bound"] == replays
    assert delta["copy_in_bytes"] == 0 and delta["upload_bytes"] == 0
    assert len({o.data_ptr() for o in outs}) == 30  # a fresh output a call
    wants = [_per_image(single, g) for g in groups]
    for k, out in enumerate(outs):
        assert torch.equal(out, wants[k % 3]), k


def test_a_plan_binds_then_copies_then_binds(cuda):
    """One plan: an aligned batch is bound, a view one byte off the
    alignment K2 was captured with is copied in (its output still bound),
    and the next aligned batch is bound again; every output byte-equal."""
    from imageprocessingtools_tpu_torch.parallel import batch

    xs = [_image((2, 136, 256, 3), seed=s).to(cuda) for s in (151, 152, 153)]
    batch.batched_fused_pipeline(xs[0])  # the capture, the plan
    before = _plan_counts()
    for x, bound in zip([xs[0], _misaligned(xs[1]), xs[2]], (True, False, True)):
        step = _plan_counts()
        out = batch.batched_fused_pipeline(x)
        delta = _plan_delta(step)
        assert delta["dispatch_plan_hits"] == 1 and delta["inputs_bound"] == bound
        assert delta["outputs_bound"] == 1 and delta["copy_in_bytes"] == (0 if bound else x.nbytes)
        assert torch.equal(out, _per_image(fused.fused_pipeline_mega, x))
    delta = _plan_delta(before)
    assert delta["dispatch_plans_made"] == 0 and delta["graphs_captured"] == 0


def test_a_plan_is_dropped_when_its_graph_is(cuda, monkeypatch):
    """Under a byte bound that holds one graph, a call of another shape
    drops the first shape's graph: the first shape's plan is dropped with it
    (its graph is freed, never replayed), and its next call captures again
    and leaves a new plan."""
    import gc
    import weakref

    from imageprocessingtools_tpu_torch.parallel import batch
    from imageprocessingtools_tpu_torch.utils import graphs

    monkeypatch.setattr(graphs, "_held", collections.OrderedDict())  # other tests' graphs aside
    monkeypatch.setattr(graphs, "GRAPH_BYTES_BOUND", 1)
    x, y = _image((2, 152, 256, 3), seed=161).to(cuda), _image((2, 160, 256, 3), seed=162).to(cuda)
    batch.batched_fused_pipeline(x)
    (first,) = [e for e in graphs._live() if tuple(e.static_in.shape) == tuple(x.shape)]
    first = weakref.ref(first)
    batch.batched_fused_pipeline(x)
    before = _plan_counts()
    batch.batched_fused_pipeline(y)  # drops x's graph
    gc.collect()
    assert first() is None
    out = batch.batched_fused_pipeline(x)
    delta = _plan_delta(before)
    assert delta["graphs_captured"] == 2 and delta["graphs_evicted"] == 2
    assert delta["dispatch_plans_made"] == 2 and delta["dispatch_plan_hits"] == 0
    assert torch.equal(out, _per_image(fused.fused_pipeline_mega, x))
    again = batch.batched_fused_pipeline(x)
    assert _plan_delta(before)["dispatch_plan_hits"] == 1 and torch.equal(again, out)


def test_a_plan_on_a_second_stream_waits_for_the_graphs_last_call(cuda):
    """Calls that take a plan on a side stream, then on the default one:
    each waits for the graph's last call on the other stream (``done``); an
    input made on the default stream and dropped by its caller at once is
    read before the default stream's next allocations reuse its bytes;
    every output byte-equal."""
    from imageprocessingtools_tpu_torch.parallel import batch

    x = _image((2, 144, 256, 3), seed=171).to(cuda)
    want = _per_image(fused.fused_pipeline_mega, x)
    batch.batched_fused_pipeline(x)  # the capture and the plan, on the default stream
    ys = [x.clone() for _ in range(3)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = _plan_counts()
    outs = []
    with torch.cuda.stream(side):
        while ys:
            outs.append(batch.batched_fused_pipeline(ys.pop()))
    noise = [torch.full_like(x, 7) for _ in range(3)]  # may take the dropped inputs' bytes
    main = [batch.batched_fused_pipeline(x) for _ in range(2)]
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert _plan_delta(before)["dispatch_plan_hits"] == 5 and len(noise) == 3
    assert all(torch.equal(o, want) for o in outs + main)


def test_a_capture_that_draws_random_numbers_is_refused(cuda):
    """A replay launched by the library would draw a captured op's random
    numbers again: such a function cannot be captured."""
    from imageprocessingtools_tpu_torch.utils import graphs

    g = graphs.graphed(lambda x: x + torch.randint_like(x, 2))
    with pytest.raises(graphs.CaptureError, match="random numbers"):
        g(_image((8, 8, 3), seed=0).to(cuda))


# ---------------------------------------------------------------------------
# Batched graphs (utils/graphs.py::batched): serving's and the batch module's
# jax.jit(jax.vmap(fn)), one replay per group of images.
# ---------------------------------------------------------------------------

def _batch_tasks():
    from imageprocessingtools_tpu_torch.pipeline import PipelineConfig

    return {"edge_detect": "edge_detect", "enhance": "enhance", "print_ready": "print_ready",
            "thumbnail": "thumbnail",
            "fanout -gray;-w1920 -r30": (PipelineConfig(gray=True),
                                         PipelineConfig(new_width=1920, angle=30.0)),
            "-w1920 -r30 -mono -fv": PipelineConfig(new_width=1920, angle=30.0, mono=True,
                                                    flip_v=True)}


def _host_batch(n, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n,) + shape, dtype=np.uint8)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("shape", [(2160, 3840, 3), (1080, 1920, 3)])
@pytest.mark.parametrize("task", list(_batch_tasks()))
def test_batched_graphs_equal_the_eager_loop(cuda, task, shape):
    """G + 1 images (G is 10 at 4K, 43 at 1080p): a replay of the G-image
    graph, then one of the 1-image remainder's, byte-equal to the eager loop."""
    from imageprocessingtools_tpu_torch import serving
    from imageprocessingtools_tpu_torch.utils import graphs

    one, _ = serving._task_fn(_batch_tasks()[task])
    group = graphs.group_size(int(np.prod(shape)))
    assert group == {(2160, 3840, 3): 10, (1080, 1920, 3): 43}[shape]
    imgs = _host_batch(group + 1, shape, seed=60)
    run = graphs.batched(one)
    got = _as_tuple(run(imgs, cuda))
    want = _as_tuple(graphs.eager_batch(one, torch.from_numpy(imgs).to(cuda)))
    keys = [k for k in graphs._batch_graphs if k[0] is one and k[2] == shape]
    assert sorted(k[4] for k in keys) == [1, group]
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g, w)


def test_batched_graphs_leave_the_first_chunks_outputs_alone(cuda):
    from imageprocessingtools_tpu_torch import serving
    from imageprocessingtools_tpu_torch.utils import graphs

    one, _ = serving._task_fn("enhance")
    run = graphs.batched(one)
    chunks = [_host_batch(2, (1080, 1920, 3), seed=s) for s in (61, 62)]
    first = run(chunks[0], cuda)
    kept = first.clone()
    second = run(chunks[1], cuda)
    torch.cuda.synchronize()
    assert torch.equal(first, kept) and not torch.equal(first, second)
    static = graphs._batch_graphs[(one, first.device, (1080, 1920, 3), torch.uint8, 2)]
    out = static.captured.out  # enhance's batch form: the graph's own stack of the two
    assert isinstance(out, torch.Tensor) and tuple(out.shape) == (2, 1080, 1920)
    assert not (first.data_ptr() <= out.data_ptr() < first.data_ptr() + first.nbytes)
    assert torch.equal(second, graphs.eager_batch(one, torch.from_numpy(chunks[1]).to(cuda)))


@pytest.mark.parametrize("task", ["print_ready", "fanout -gray;-w1920 -r30"])
def test_batched_mesh_shards_equal_the_one_device_run(cuda, task):
    from imageprocessingtools_tpu_torch import serving
    from imageprocessingtools_tpu_torch.parallel.batch import batch_apply, gather

    config = _batch_tasks()[task]
    one, _ = serving._task_fn(config)
    card = torch.device("cuda", torch.cuda.current_device())
    imgs = _host_batch(5, (1080, 1920, 3), seed=63)
    whole = _as_tuple(batch_apply(one, imgs))
    shards = batch_apply(one, np.concatenate([imgs, imgs[-1:]]), mesh=(card, card))
    for k, joined in enumerate(_as_tuple(gather(shards, card))):
        assert torch.equal(joined[:5], whole[k])
    padded, _ = serving.process_batch(imgs, config, mesh=(card,) * 3)  # 5 images, 2 padded
    host = serving._to_host(padded)
    for k, (joined, h) in enumerate(zip(_as_tuple(gather(padded, card)), _as_tuple(host))):
        assert torch.equal(joined, whole[k]) and np.array_equal(h, whole[k].cpu().numpy())


def test_batch_apply_over_a_graphed_alias(cuda):
    """A ``graphed`` callable inside a batch's capture runs its body, which
    the batch's graph captures (as a jitted function inlines under
    ``jax.jit``): no graph of its own, and the bytes of the eager forms."""
    from imageprocessingtools_tpu_torch import kernels
    from imageprocessingtools_tpu_torch.parallel.batch import batch_apply
    from imageprocessingtools_tpu_torch.utils import graphs

    alias = kernels.fused_gray_gauss_histeq
    imgs = _host_batch(3, (540, 960, 3), seed=65)
    own = set(alias._graphs)
    got = batch_apply(alias, imgs)
    assert set(alias._graphs) == own and graphs._holds is None
    want = torch.stack([fused.fused_pipeline_mega(torch.from_numpy(i).to(cuda)) for i in imgs])
    assert torch.equal(got, want)
    assert torch.equal(batch_apply(alias, imgs[::-1].copy()), want.flip(0))


def test_an_out_of_memory_error_in_a_capture_reaches_serves_surface(cuda, tmp_path,
                                                                     monkeypatch, capsys):
    """The card's allocator refuses every new segment once a capture has
    begun (a per-process memory fraction at what is reserved), so the graph's
    pool cannot be made: ``serve`` prints the C's allocation message and
    exits 255, as for an out-of-memory error outside a capture."""
    from imageprocessingtools_tpu_torch import serve
    from imageprocessingtools_tpu_torch.codec import ppm
    from imageprocessingtools_tpu_torch.ops import _exact

    path = str(tmp_path / "frame.ppm")
    ppm.write_ppm(path, _host_batch(1, (720, 1296, 3), seed=64)[0])  # a shape no test captured
    card = torch.device("cuda", torch.cuda.current_device())
    real = torch.cuda.CUDAGraph.capture_begin
    total = torch.cuda.get_device_properties(card).total_memory

    def capture_begin(self, *args, **kwargs):
        torch.cuda.set_per_process_memory_fraction(
            torch.cuda.memory_reserved(card) / total, card)
        return real(self, *args, **kwargs)

    torch.cuda.empty_cache()
    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", capture_begin)
    try:
        rc = serve.main(["--preset", "enhance", path])
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, card)
    assert (rc, capsys.readouterr().out) == (255, _exact.B9_MESSAGE)
    monkeypatch.undo()
    assert serve.main(["--preset", "enhance", path]) == 0  # the card still serves


# ---------------------------------------------------------------------------
# Compiled band pipelines (parallel/spatial.py::band_outputs): the JAX
# package's jax.jit(shard_map(...)) per (shape, mesh), one graph on a card.
# ---------------------------------------------------------------------------

def _band_tasks():
    from imageprocessingtools_tpu_torch.pipeline import PipelineConfig

    presets = ("edge_detect", "enhance", "print_ready", "thumbnail")
    return {"fused": "fused", **{name: name for name in presets},
            "-w120": PipelineConfig(new_width=120), "-r30": PipelineConfig(angle=30.0),
            "-r90": PipelineConfig(angle=90.0), "-r180": PipelineConfig(angle=180.0),
            "-w150 -r30 -mono -fv": PipelineConfig(new_width=150, angle=30.0, mono=True,
                                                   flip_v=True),
            "fanout of the presets": presets}


def _unsharded(task, img):
    from imageprocessingtools_tpu_torch.models import PRESETS
    from imageprocessingtools_tpu_torch.pipeline import run_pipeline

    if isinstance(task, tuple):
        return tuple(_unsharded(item, img) for item in task)
    if task == "fused":
        return fused.fused_pipeline_mega(img)
    if isinstance(task, str):
        return PRESETS[task](img)
    return run_pipeline(img, task)[0]


def _gathered(out, device):
    from imageprocessingtools_tpu_torch.parallel import spatial

    if isinstance(out, tuple):
        return tuple(_gathered(o, device) for o in out)
    assert all(b.data.device == device for b in out)
    return spatial.gather(out, device)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("label", list(_band_tasks()))
def test_compiled_band_pipelines_equal_the_eager_bands_and_the_unsharded_path(cuda, label, n):
    """One graph per (task, shape, mesh) on a mesh that names the card n
    times, fed from the host and from the card, byte-equal to the eager band
    form and to the unsharded path; a second call captures nothing and
    leaves the first call's outputs alone."""
    from imageprocessingtools_tpu_torch.parallel import spatial
    from imageprocessingtools_tpu_torch.utils import graphs

    task = _band_tasks()[label]
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = (dev,) * n
    host = _image((211, 307, 3), seed=70 + n).numpy()  # a shape no other test captures
    src = torch.from_numpy(host).to(dev)
    captures = graphs.captures_made
    from_host = spatial.band_pipeline(task, host, mesh)
    assert graphs.captures_made == captures + 1
    assert spatial.graph_key(task, host.shape, torch.uint8, mesh) in spatial._band_graphs
    kept = _gathered(from_host, dev)
    other = _image((211, 307, 3), seed=80 + n).to(dev)
    from_card = spatial.band_pipeline(task, other, mesh)
    assert graphs.captures_made == captures + 1  # the same graph, replayed
    eager = spatial.band_pipeline(task, spatial.shard_rows(src, mesh), mesh)
    for got, want in ((kept, _gathered(eager, dev)), (kept, _unsharded(task, src)),
                      (_gathered(from_card, dev), _unsharded(task, other)),
                      (_gathered(from_host, dev), kept)):
        for g, w in zip(*((x,) if not isinstance(task, tuple) else x for x in (got, want))):
            assert torch.equal(g, w)


def test_an_uncapturable_band_body_raises_capture_error(cuda, monkeypatch):
    from imageprocessingtools_tpu_torch.parallel import spatial
    from imageprocessingtools_tpu_torch.utils import graphs

    dev = torch.device("cuda", torch.cuda.current_device())
    img = _image((131, 257, 3), seed=90).to(dev)  # a shape no other test captures
    real = spatial._equalize_lut

    def uploads(hist, n_pixels):  # a host upload on every call: cannot be captured
        return real(hist, n_pixels) + torch.tensor([0], dtype=torch.uint8, device=hist.device)

    monkeypatch.setattr(spatial, "_equalize_lut", uploads)
    with pytest.raises(graphs.CaptureError, match="spatial fused on 4 bands"):
        spatial.fused_pipeline_spatial(img, (dev,) * 4)
    assert spatial.graph_key("fused", img.shape, img.dtype, (dev,) * 4) \
        not in spatial._band_graphs
    monkeypatch.undo()
    got = spatial.gather(spatial.fused_pipeline_spatial(img, (dev,) * 4), dev)
    assert torch.equal(got, fused.fused_pipeline_mega(img))


def test_an_out_of_memory_error_in_a_band_capture_reaches_serves_surface(cuda, tmp_path,
                                                                          monkeypatch, capsys):
    """As for a batch graph: ``serve --spatial`` prints the C's allocation
    message and exits 255 when a band graph's pool cannot be made."""
    from imageprocessingtools_tpu_torch import serve
    from imageprocessingtools_tpu_torch.codec import ppm
    from imageprocessingtools_tpu_torch.ops import _exact

    path = str(tmp_path / "giant.ppm")
    ppm.write_ppm(path, _host_batch(1, (712, 1304, 3), seed=91)[0])  # a shape no test captured
    card = torch.device("cuda", torch.cuda.current_device())
    real = torch.cuda.CUDAGraph.capture_begin
    total = torch.cuda.get_device_properties(card).total_memory

    def capture_begin(self, *args, **kwargs):
        torch.cuda.set_per_process_memory_fraction(
            torch.cuda.memory_reserved(card) / total, card)
        return real(self, *args, **kwargs)

    torch.cuda.empty_cache()
    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", capture_begin)
    try:
        rc = serve.main(["--spatial", "--preset", "enhance", path])
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, card)
    assert (rc, capsys.readouterr().out) == (255, _exact.B9_MESSAGE)
    monkeypatch.undo()
    assert serve.main(["--spatial", "--preset", "enhance", path]) == 0  # the card still serves
