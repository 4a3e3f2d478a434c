"""Each reference equals the port's CPU path at a small size, its control does
not, and no reference imports JAX or anything of the port."""

import ast

import numpy as np
import pytest
import torch

from port_bench import frames, spec
from port_bench.reference import flagship_4k, thumbnail_4k

FORBIDDEN = {"jax", "jaxlib", "flax", "imageprocessingtools_tpu", "imageprocessingtools_tpu_torch"}


def test_references_import_no_jax_and_nothing_of_the_port():
    for path in sorted((spec.BENCH / "reference").glob("*.py")):
        names = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names |= {a.name.partition(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                names.add((node.module or "").partition(".")[0])
        assert not names & FORBIDDEN, (path.name, names & FORBIDDEN)


@pytest.mark.parametrize("shape", [(48, 80), (37, 53)])
def test_flagship_reference_equals_the_port(on_cpu, shape):
    from imageprocessingtools_tpu_torch.kernels.fused import fused_pipeline, fused_pipeline_mega
    from imageprocessingtools_tpu_torch.parallel.batch import batched_fused_pipeline

    imgs = frames.frames(3, *shape, seed=11, device="cpu")
    want = flagship_4k.expected(imgs, {})
    assert torch.equal(want, batched_fused_pipeline(imgs))
    for img, out in zip(imgs, want):
        assert torch.equal(out, fused_pipeline_mega(img))
        assert torch.equal(out, fused_pipeline(img))


def test_flagship_reference_on_a_constant_image(on_cpu):
    from imageprocessingtools_tpu_torch.kernels.fused import fused_pipeline

    img = torch.full((1, 20, 30, 3), 77, dtype=torch.uint8)
    assert torch.equal(flagship_4k.expected(img, {})[0], fused_pipeline(img[0]))


@pytest.mark.parametrize("shape", [(90, 640), (36, 64), (21, 300)])
def test_thumbnail_reference_equals_the_port(on_cpu, shape):
    from imageprocessingtools_tpu_torch import serving
    from imageprocessingtools_tpu_torch.ops.resize import resize_width

    imgs = frames.frames(2, *shape, seed=12, device="cpu")
    want = thumbnail_4k.expected(imgs, {"new_width": 256})
    out, _ = serving.process_batch(imgs.numpy(), "thumbnail")
    assert torch.equal(want, out)
    for img, w in zip(imgs, want):
        assert torch.equal(w, resize_width(img, 256))


def test_thumbnail_file_bytes_are_the_port_s_encoding(on_cpu):
    from imageprocessingtools_tpu_torch.codec.ppm import encode_ppm

    out = thumbnail_4k.expected(frames.frames(1, 90, 640, seed=3, device="cpu"),
                                {"new_width": 256})[0]
    assert thumbnail_4k.file_bytes(out, {"max_color": 255}) == encode_ppm(out.numpy())


@pytest.mark.parametrize("ref, config, shape", [
    (flagship_4k, {}, (48, 80)),
    (thumbnail_4k, {"new_width": 256}, (90, 640)),
])
def test_the_lower_precision_control_differs(ref, config, shape):
    imgs = frames.frames(2, *shape, seed=5, device="cpu")
    assert int((ref.expected(imgs, config) != ref.control(imgs, config)).sum()) > 0


def test_frames_are_seeded_photo_like_and_sized_alike():
    a = frames.frames(2, 40, 60, seed=2**31 + 5, device="cpu")
    assert torch.equal(a, frames.frames(2, 40, 60, seed=2**31 + 5, device="cpu"))
    b = frames.frames(2, 40, 60, seed=2**31 + 6, device="cpu")
    assert a.shape == b.shape == (2, 40, 60, 3) and a.dtype == torch.uint8
    assert not torch.equal(a, b)
    # peaked, not flat: the most common gray level holds far more than 1/256
    gray = a.to(torch.int32).sum(-1) // 3
    counts = np.bincount(gray.reshape(-1).numpy(), minlength=256)
    assert counts.max() > 4 * counts.sum() / 256
