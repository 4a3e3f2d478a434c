"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The plain versions are held to the JAX package and the golden
model by the CPU suites (tests/test_torch_rotate.py, test_torch_fused.py,
test_torch_stencil.py, test_torch_histogram.py);
here each kernel must give the same bytes as its plain version on the same
CUDA tensors. Tolerance: none — every kernel is integer- or f64-exact.

This file imports neither JAX nor tests/conftest.py, so it also runs on a
machine without JAX:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu_torch.kernels import core, fused, rotate

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _image(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8))


@pytest.mark.parametrize("shape,angle", [
    ((37, 53, 3), 117.0), ((48, 64, 3), 30.0), ((64, 48, 3), 135.0),
    ((16, 16), 45.0), ((29, 7), 333.3), ((1, 5, 3), 30.0), ((3, 3), 245.0),
    ((200, 160, 3), 1.0),
])
def test_rotate_kernel_matches_plain(cuda, shape, angle):
    img = _image(shape, seed=sum(shape)).to(cuda)
    before = rotate.rotate_bicubic.launches
    out = rotate.rotate_bicubic(img, angle)
    torch.cuda.synchronize()
    assert rotate.rotate_bicubic.launches == before + 1
    exp = rotate.rotate_plain(img, angle)
    assert out.shape == exp.shape and out.dtype == torch.uint8
    assert torch.equal(out, exp)


@pytest.mark.parametrize("shape", [(5, 17), (1, 1), (29, 130), (64, 300), (33, 129)])
def test_gray_gauss_hist_kernel_matches_plain(cuda, shape):
    img = _image(shape + (3,), seed=shape[0] * 1000 + shape[1]).to(cuda)
    before = core.gray_gauss_hist.launches
    blurred, hist = core.gray_gauss_hist(img)
    torch.cuda.synchronize()
    assert core.gray_gauss_hist.launches == before + 1
    exp_blurred, exp_hist = core.gray_gauss_hist_plain(img)
    assert torch.equal(blurred, exp_blurred)
    assert hist.dtype == torch.int32 and torch.equal(hist, exp_hist)
    assert int(hist.sum()) == shape[0] * shape[1]


@pytest.mark.parametrize("n,offset", [(4096, 0), (1000, 0), (1000, 3), (7, 1)])
def test_lut_apply_kernel_matches_plain(cuda, n, offset):
    values = _image((n + offset,), seed=n)[offset:].to(cuda)
    lut = _image((256,), seed=n + 1).to(cuda)
    before = core.lut_apply.launches
    out = core.lut_apply(values, lut)
    torch.cuda.synchronize()
    assert core.lut_apply.launches == before + 1
    assert torch.equal(out, core.lut_apply_plain(values, lut))


@pytest.mark.parametrize("kind", ["noise", "constant", "offset"])
@pytest.mark.parametrize("shape", [(1, 1), (5, 17), (37, 53), (64, 300), (1, 4099)])
def test_histogram_kernel_matches_plain(cuda, shape, kind):
    img = _image(shape, seed=shape[0] * 31 + shape[1]).to(cuda)
    if kind == "constant":
        img.fill_(201)
    elif kind == "offset":  # an unaligned view takes the byte-wise loop
        img = _image((img.numel() + 1,), seed=shape[1]).to(cuda)[1:]
    before = core.histogram.launches
    hist = core.histogram(img)
    torch.cuda.synchronize()
    assert core.histogram.launches == before + 1
    assert hist.dtype == torch.int32 and torch.equal(hist, core.histogram_plain(img))
    assert int(hist.sum()) == img.numel()


_STENCILS = [
    (core.gaussian_blur, core.gaussian_blur_plain),
    (core.box_blur, core.box_blur_plain),
    (core.sharpen, core.sharpen_plain),
    (core.sobel, core.sobel_plain),
]


@pytest.mark.parametrize("kind", ["noise", "edges"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (5, 1), (2, 3), (37, 53), (33, 129),
                                   (70, 300)])
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


def test_fused_mega_matches_plain(cuda):
    img = _image((70, 150, 3), seed=5).to(cuda)
    out = fused.fused_pipeline_mega(img)
    torch.cuda.synchronize()
    assert torch.equal(out, fused.fused_pipeline(img))


def test_fused_staged_matches_plain(cuda):
    img = _image((70, 150, 3), seed=6).to(cuda)
    counts = (core.gaussian_blur.launches, core.histogram.launches, core.lut_apply.launches)
    out = fused.fused_pipeline_staged(img)
    torch.cuda.synchronize()
    assert (core.gaussian_blur.launches, core.histogram.launches,
            core.lut_apply.launches) == tuple(n + 1 for n in counts)
    assert torch.equal(out, fused.fused_pipeline(img))


def test_plain_versions_launch_no_kernel(cuda):
    img = _image((40, 60, 3), seed=7).to(cuda)
    wrappers = (core.gray_gauss_hist, core.lut_apply, core.histogram, core.gaussian_blur,
                core.box_blur, core.sharpen, core.sobel)
    before = [w.launches for w in wrappers]
    gray = img[:, :, 0].contiguous()
    fused.fused_pipeline(img)
    core.gray_gauss_hist_plain(img)
    for _, plain in _STENCILS:
        plain(gray)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == before


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    img = _image((8, 10, 3), seed=1).to(cuda)
    with pytest.raises(TypeError):
        rotate.rotate_bicubic(img.transpose(0, 1), 30.0)
    with pytest.raises(TypeError):
        core.gray_gauss_hist(img[:, :, :2].contiguous())
    with pytest.raises(TypeError):
        core.gray_gauss_hist(img.to(torch.int32))
    with pytest.raises(TypeError):
        core.lut_apply(img[:, :, 0].contiguous(), torch.arange(256, device=cuda))
    with pytest.raises(TypeError):
        core.histogram(img.transpose(0, 1))
    for wrapper, _ in _STENCILS:
        with pytest.raises(TypeError):
            wrapper(img)  # HWC: the kernels take one gray plane
        with pytest.raises(TypeError):
            wrapper(img[:, :, 0])  # not contiguous
