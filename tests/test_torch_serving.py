"""The port's server (``serve.main``, ``serving.process_files``) against the
JAX package's, on the same files, on the CPU.

Each case writes the same P6 inputs (numpy seeds) into two directories and
serves one with each package. Exit codes, stdout and the skip lines on
stderr must be equal, and every output file must exist on both sides with
the same bytes. Tolerance: none, except for outputs of a chain with a
resize (``thumbnail``, ``-wN``), whose pixels are held to
``float_stage_budget(True)`` (2) with identical headers.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu import serve as jax_serve
from imageprocessingtools_tpu.codec import native as jax_native
from imageprocessingtools_tpu_torch import serve, serving
from imageprocessingtools_tpu_torch.codec import native, ppm
from imageprocessingtools_tpu_torch.ops.common import float_stage_budget
from imageprocessingtools_tpu_torch.ops.packing import pack_bits_device
from imageprocessingtools_tpu_torch.pipeline import PipelineConfig
from tests.conftest import make_gradient, make_image

TWO_BUCKETS = [(16, 24), (24, 32), (16, 24)]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPT_DEVICE", "cpu")


def _write_inputs(directory, shapes, bad=False):
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, (h, w) in enumerate(shapes):
        img = make_image(h, w, seed=i) if i % 2 == 0 else make_gradient(h, w)
        paths.append(os.path.join(directory, f"in{i}.ppm"))
        ppm.write_ppm(paths[-1], img, max_color=255 - i)  # maxval passes through (B5)
    if bad:
        paths.append(os.path.join(directory, "truncated.ppm"))
        with open(paths[-1], "wb") as f:
            f.write(b"P6\n4 4\n255\n" + bytes(20))
    return paths


def _outputs(directory):
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory)) if not name.endswith(".ppm")}


def _serve(main, directory, args, shapes, capsys, bad=False, before=None):
    paths = _write_inputs(directory, shapes, bad=bad)
    if before:
        before(paths)
    rc = main(args + paths)
    cap = capsys.readouterr()
    err = re.sub(r"processed in \S+s \(\S+ files/s\)", "processed",
                 cap.err.replace(str(directory), "<dir>"))
    return rc, cap.out, err, _outputs(directory)


def _assert_same_outputs(jax_files, port_files, resize_chain=False):
    assert sorted(port_files) == sorted(jax_files)
    for name, exp in jax_files.items():
        got = port_files[name]
        if got == exp:
            continue
        assert resize_chain or "thumbnail" in name or ".w" in name, name
        a, _, type_a = ppm.decode_pnm(got)
        b, _, type_b = ppm.decode_pnm(exp)
        assert type_a == type_b and a.shape == b.shape, name
        assert got.split(b"\n", 3)[:3] == exp.split(b"\n", 3)[:3], name
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32)).max()
        assert diff <= float_stage_budget(True), (name, diff)


def _both(tmp_path, capsys, args, shapes=TWO_BUCKETS, bad=False, before=None,
          resize_chain=False):
    jax = _serve(jax_serve.main, tmp_path / "jax", args, shapes, capsys, bad, before)
    port = _serve(serve.main, tmp_path / "port", args, shapes, capsys, bad, before)
    assert port[:3] == jax[:3]
    _assert_same_outputs(jax[3], port[3], resize_chain)
    return port


@pytest.mark.parametrize("preset", ["edge_detect", "enhance", "print_ready", "thumbnail"])
def test_serve_each_preset_matches_jax(tmp_path, capsys, preset):
    rc, _, err, files = _both(tmp_path, capsys, ["--preset", preset],
                              resize_chain=preset == "thumbnail")
    assert rc == 0 and "3 files processed" in err
    assert len(files) == 3


def test_serve_four_presets_fan_out_matches_jax(tmp_path, capsys):
    rc, _, _, files = _both(
        tmp_path, capsys,
        ["--preset", "edge_detect,enhance,print_ready,thumbnail", "--max-batch", "1"])
    assert rc == 0 and len(files) == 12
    assert "in1.ppm.print_ready.out" in files


def test_serve_fanout_with_preset_matches_jax(tmp_path, capsys):
    rc, _, _, files = _both(
        tmp_path, capsys, ["--preset", "enhance", "--fanout", "-gray;-w10 -r30;-mono -fh"],
        shapes=[(16, 24), (16, 24)], resize_chain=True)
    assert rc == 0
    assert sorted(files) == sorted(f"in{i}.ppm.{t}.out" for i in range(2)
                                   for t in ("enhance", "gray", "w10-r30", "mono-fh"))


@pytest.mark.parametrize("flags", [["-r30", "-mono"], ["-w12", "-gray", "-fv"], ["-r90"]])
def test_serve_reference_flags_match_jax(tmp_path, capsys, flags):
    rc, *_ = _both(tmp_path, capsys, flags + ["--sequential"],
                   resize_chain=any(f.startswith("-w") for f in flags))
    assert rc == 0


def test_serve_skip_bad_matches_jax(tmp_path, capsys):
    rc, out, err, files = _both(tmp_path, capsys,
                                ["--skip-bad", "--preset", "print_ready,edge_detect"], bad=True)
    assert rc == 0 and out == ""
    assert "skipped <dir>/truncated.ppm: Error: unexpected end of file." in err
    assert "1 bad skipped" in err and len(files) == 6


def test_serve_resume_matches_jax(tmp_path, capsys):
    def stale(paths):
        with open(paths[1] + ".out", "wb") as f:
            f.write(b"stale sentinel")

    rc, _, err, files = _both(tmp_path, capsys, ["--resume", "--preset", "enhance"],
                              before=stale)
    assert rc == 0 and "2 files processed" in err and "1 skipped" in err
    assert files["in1.ppm.out"] == b"stale sentinel"


def test_serve_fail_fast_matches_jax(tmp_path, capsys):
    rc, out, _, files = _both(tmp_path, capsys, ["--preset", "enhance"], bad=True)
    assert rc == 255 and out == "Error: unexpected end of file.\n" and files == {}


@pytest.mark.parametrize("args", [
    [],
    ["--preset", "bogus", "x.ppm"],
    ["--preset", "enhance,enhance", "x.ppm"],
    ["--preset", "enhance", "-gray", "x.ppm"],
    ["--max-batch", "0", "-gray", "x.ppm"],
    ["-gray", "/nonexistent/definitely-missing.ppm"],
    ["--fanout", "-gray;-gray", "x.ppm"],
    ["-gray", "-mono", "x.ppm"],
    ["--bogus", "x.ppm"],
    ["-w0", "x.ppm"],
])
def test_serve_probes_match_jax(tmp_path, capsys, args):
    args = [str(tmp_path / a) if a == "x.ppm" else a for a in args]
    if any(a.endswith("x.ppm") for a in args):
        ppm.write_ppm(str(tmp_path / "x.ppm"), make_image(4, 6))
    rc_jax = jax_serve.main(list(args))
    out_jax = capsys.readouterr().out
    rc = serve.main(list(args))
    assert (rc, capsys.readouterr().out) == (rc_jax, out_jax)
    assert rc == 255


@pytest.mark.parametrize("flag", ["--mesh", "--spatial"])
def test_serve_unported_options_fail_loudly(tmp_path, capsys, flag):
    path = str(tmp_path / "x.ppm")
    ppm.write_ppm(path, make_image(4, 6))
    assert serve.main([flag, "--preset", "enhance", path]) == 255
    assert capsys.readouterr().out == f"Error: {flag} is not available in the port yet " \
                                      "(use imageprocessingtools_tpu.serve)\n"
    assert not os.path.exists(path + ".out")


def test_process_files_writer_error_no_deadlock(tmp_path, monkeypatch):
    paths = _write_inputs(tmp_path, [(8, 16)] * 6)
    real = serving._encode_chunk
    calls = {"n": 0}

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("No space left on device")
        return real(*args, **kw)

    monkeypatch.setattr(serving, "_encode_chunk", flaky)
    with pytest.raises(OSError, match="No space left"):
        serving.process_files(paths, PipelineConfig(gray=True), suffix=".wd", max_batch=2)


@pytest.mark.parametrize("config,shape", [
    ("thumbnail", (59, 256, 3)),
    ("edge_detect", (7, 30)),
    (PipelineConfig(new_width=12, angle=30.0, mono=True), None),
    (PipelineConfig(angle=270.0), None),
    (PipelineConfig(angle=180.0, gray=True), None),
])
def test_task_unpacked_shape_is_the_output_shape(config, shape):
    img = torch.from_numpy(make_image(7, 30))
    one, _ = serving._task_fn(config)
    unpacked = serving._task_unpacked_shape(config, 7, 30)
    if shape is not None:
        assert unpacked == shape
    if isinstance(config, PipelineConfig) and config.mono:
        assert tuple(one(img).shape) == (unpacked[0], -(-unpacked[1] // 8))
    else:
        assert tuple(one(img).shape) == unpacked


@pytest.mark.parametrize("width", range(1, 18))
def test_pack_bits_device_matches_numpy(width):
    bits = np.random.default_rng(width).integers(0, 2, size=(2, 3, width), dtype=np.uint8)
    out = pack_bits_device(torch.from_numpy(bits))
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), np.packbits(bits, axis=-1))


def test_native_codec_matches_jax(tmp_path):
    assert native.available() and jax_native.available()
    paths = _write_inputs(tmp_path, [(9, 13)] * 3, bad=True)
    for p in paths[:3]:
        assert native.parse_file_header(p) == jax_native.parse_file_header(p)
    with pytest.raises(ppm.PPMError) as err:
        native.parse_file_header(paths[3])
    assert err.value.message == "Error: unexpected end of file.\n"
    batch, errs = native.decode_batch_files(paths, 9, 13)
    exp, exp_errs = jax_native.decode_batch_files(paths, 9, 13)
    assert errs == exp_errs == {3: ("ppm", "Error: unexpected end of file.\n")}
    np.testing.assert_array_equal(batch[:3], exp[:3])
    data = [open(p, "rb").read() for p in paths[:3]]
    np.testing.assert_array_equal(native.decode_batch(data)[0], jax_native.decode_batch(data)[0])
    bits = (batch[:3, :, :, 0] > 127).astype(np.uint8)
    assert native.pack_bits(bits[0]) == jax_native.pack_bits(bits[0])
    for file_type, arr, dims in ((0, batch[:3], None), (1, batch[:3, :, :, 1], None),
                                 (2, np.packbits(bits, axis=-1), (9, 13))):
        for side, mod in (("port", native), ("jax", jax_native)):
            mod.encode_batch_files([str(tmp_path / f"{side}{i}.{file_type}") for i in range(3)],
                                   arr, file_type, [255, 7, 65535], p4_dims=dims)
        for i in range(3):
            assert (open(tmp_path / f"port{i}.{file_type}", "rb").read()
                    == open(tmp_path / f"jax{i}.{file_type}", "rb").read())


def test_native_codec_builds_the_jax_source_by_path():
    """The port builds its own copy of the C++ codec, which must stay
    byte-identical to the JAX package's source (a drift check)."""
    port_codec = os.path.dirname(os.path.abspath(native.__file__))
    jax_codec = os.path.dirname(os.path.abspath(jax_native.__file__))
    assert native.SOURCE.name == "ppmcodec.cpp" and native.SOURCE.exists()
    assert str(native.SOURCE) == os.path.join(port_codec, "csrc", "ppmcodec.cpp")
    with open(os.path.join(jax_codec, "csrc", "ppmcodec.cpp"), "rb") as f:
        assert native.SOURCE.read_bytes() == f.read()
    assert native.BUILD_DIR.parts[-2:] == ("build", "imageprocessingtools_tpu_torch")
