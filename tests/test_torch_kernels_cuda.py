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

import importlib

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
    for dim, idx, wts in k9.device_passes(h, w, new_width, cuda):
        if dim == 0:
            break
        src = k9.resize_pass(src, idx, wts, dim)  # the W pass first
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
