"""The port's server (``serve.main``, ``serving.process_files``,
``serving.process_file_spatial``, with and without ``--mesh`` and
``--spatial``) against the JAX package's, on the same files, on the CPU.

Each case writes the same P6 inputs (numpy seeds) into two directories and
serves one with each package. Exit codes, stdout and the skip lines on
stderr must be equal, and every output file must exist on both sides with
the same bytes. Tolerance: none, except for outputs of a chain with a
resize (``thumbnail``, ``-wN``): the port's are exact (held byte-equal to the
golden model below), the JAX package's are float32 matrix products, so the
two are held to that package's ``float_stage_budget(True, False)`` (2) with
identical headers.
"""

from __future__ import annotations

import collections
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu import serve as jax_serve
from imageprocessingtools_tpu.codec import native as jax_native
from imageprocessingtools_tpu.golden import model as golden
from imageprocessingtools_tpu.ops.common import float_stage_budget as jax_budget
from imageprocessingtools_tpu_torch import serve, serving
from imageprocessingtools_tpu_torch.codec import native, ppm
from imageprocessingtools_tpu_torch.ops.packing import pack_bits_device
from imageprocessingtools_tpu_torch.pipeline import PipelineConfig
from imageprocessingtools_tpu_torch.utils import cache, profiling
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
        assert diff <= jax_budget(True, False), (name, diff)


def _golden_chain(img, flags, max_color):
    """The reference's fixed order on the golden model, encoded."""
    out, file_type = img, ppm.FILETYPE_PPM
    for f in flags:
        if f.startswith("-w"):
            out = golden.resize_width(out, int(f[2:]))
    for f in flags:
        if f.startswith("-r"):
            out = golden.rotate(out, float(f[2:]))
    if "-gray" in flags:
        out, file_type = golden.grayscale(out), ppm.FILETYPE_PGM
    if "-mono" in flags:
        out, file_type = golden.mono_dither(out), ppm.FILETYPE_PBM
    if "-fv" in flags:
        out = golden.flip_vertical(out)
    if "-fh" in flags:
        out = golden.flip_horizontal(out)
    return ppm.encode_ppm(out, file_type, max_color)


def _assert_resize_outputs_golden(directory, files, args):
    """Every output of the port whose chain has a resize (``thumbnail``, a
    ``-wN`` fan-out element, ``-wN`` reference flags) is byte-equal to the
    golden model's: the port's resize is exact. Returns how many it held."""
    held = 0
    for name, got in files.items():
        stem, _, rest = name.partition(".ppm")
        tag = rest[1:-len(".out")].strip(".")
        if not tag and "--preset" in args:  # one preset alone: no tag in the name
            tag = args[args.index("--preset") + 1]
        if tag in ("edge_detect", "enhance", "print_ready"):
            continue
        if tag == "thumbnail":
            flags = ["-w256"]
        elif tag:
            flags = ["-" + part for part in tag.split("-")]
        else:
            flags = [a for a in args if a.startswith("-") and not a.startswith("--")]
        if not any(f.startswith("-w") for f in flags):
            continue
        with open(os.path.join(directory, stem + ".ppm"), "rb") as f:
            img, max_color = ppm.decode_ppm(f.read())
        assert got == _golden_chain(img, flags, max_color), name
        held += 1
    return held


def _both(tmp_path, capsys, args, shapes=TWO_BUCKETS, bad=False, before=None,
          resize_chain=False):
    jax = _serve(jax_serve.main, tmp_path / "jax", args, shapes, capsys, bad, before)
    port = _serve(serve.main, tmp_path / "port", args, shapes, capsys, bad, before)
    assert port[:3] == jax[:3]
    _assert_same_outputs(jax[3], port[3], resize_chain)
    held = _assert_resize_outputs_golden(tmp_path / "port", port[3], args)
    assert held > 0 or not resize_chain
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


@pytest.mark.parametrize("mode", ["--mesh", "--spatial"])
@pytest.mark.parametrize("args", [
    ["--preset", "edge_detect,enhance,print_ready,thumbnail"],
    ["--preset", "enhance"],
    ["-r30", "-mono"],
    ["-w12", "-gray", "-fv"],
    ["-r90", "-fh"],
    ["--preset", "enhance", "--fanout", "-gray;-w10 -r30;-mono -fh"],
], ids=" ".join)
def test_serve_mesh_and_spatial_match_jax(tmp_path, capsys, mode, args):
    resize_chain = any(a.startswith("-w") for a in args) or "--fanout" in args
    rc, _, err, files = _both(tmp_path, capsys, [mode] + args, resize_chain=resize_chain)
    assert rc == 0 and "3 files processed" in err and files


@pytest.mark.parametrize("mode", ["--mesh", "--spatial"])
def test_serve_mesh_and_spatial_skip_bad_match_jax(tmp_path, capsys, mode):
    rc, out, err, files = _both(
        tmp_path, capsys, [mode, "--skip-bad", "--preset", "print_ready,edge_detect"], bad=True)
    assert rc == 0 and out == ""
    assert "skipped <dir>/truncated.ppm: Error: unexpected end of file." in err
    assert "1 bad skipped" in err and len(files) == 6


@pytest.mark.parametrize("mode", ["--mesh", "--spatial"])
def test_serve_mesh_and_spatial_fail_fast_match_jax(tmp_path, capsys, mode):
    rc, out, _, files = _both(tmp_path, capsys, [mode, "--preset", "enhance"], bad=True)
    assert rc == 255 and out == "Error: unexpected end of file.\n"


@pytest.mark.parametrize("mode", ["--mesh", "--spatial"])
@pytest.mark.parametrize("args", [["--preset", "thumbnail,edge_detect"], ["-r135", "-mono"]],
                         ids=" ".join)
def test_serve_mesh_and_spatial_write_the_bytes_of_a_plain_serve(tmp_path, capsys, mode, args):
    """The flags change where the work runs, never a byte."""
    plain = _serve(serve.main, tmp_path / "plain", args, TWO_BUCKETS, capsys)
    moved = _serve(serve.main, tmp_path / "moved", [mode] + args, TWO_BUCKETS, capsys)
    assert plain[0] == moved[0] == 0 and plain[3] == moved[3] and plain[3]


def test_serve_help_lists_mesh_and_spatial(capsys):
    assert serve.main(["--help"]) == 0
    err = capsys.readouterr().err
    assert "--mesh" in err and "--spatial" in err and "not available" not in err


def test_spatial_fan_out_decodes_each_file_once(tmp_path, monkeypatch):
    paths = _write_inputs(tmp_path, TWO_BUCKETS)
    decodes = []
    real = serving.ppm.decode_ppm

    def counting(data):
        decodes.append(len(data))
        return real(data)

    monkeypatch.setattr(serving.ppm, "decode_ppm", counting)
    config = ("edge_detect", "print_ready", "thumbnail", PipelineConfig(angle=30.0, mono=True))
    outs = [serving.process_file_spatial(p, config, mesh=(torch.device("cpu"),) * 3)
            for p in paths]
    assert len(decodes) == len(paths)
    assert [len(o) for o in outs] == [4] * len(paths)
    assert outs[0][3] == paths[0] + ".r30-mono.out"


@pytest.mark.parametrize("config", ["fused", "print_ready", PipelineConfig(new_width=10,
                                    angle=135.0, mono=True, flip_v=True)], ids=str)
@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_process_file_spatial_equals_the_one_device_path(tmp_path, config, n_dev):
    from imageprocessingtools_tpu_torch.kernels.fused import fused_pipeline

    path = _write_inputs(tmp_path, [(37, 53)])[0]
    img, max_color = ppm.read_ppm(path)
    out = serving.process_file_spatial(path, config, mesh=(torch.device("cpu"),) * n_dev,
                                       suffix=".sp")
    assert out == path + ".sp"
    if config == "fused":
        exp = ppm.encode_ppm(fused_pipeline(torch.from_numpy(img)).numpy(), ppm.FILETYPE_PGM,
                             max_color)
    else:
        one, file_type = serving._task_fn(config)
        unpacked = serving._task_unpacked_shape(config, 37, 53)
        packed = one(torch.from_numpy(img)).numpy()
        exp_path = str(tmp_path / "exp.out")
        native.encode_batch_files([exp_path], packed[None], file_type, [max_color],
                                  p4_dims=unpacked if file_type == ppm.FILETYPE_PBM else None)
        exp = open(exp_path, "rb").read()
    assert open(out, "rb").read() == exp


def test_process_file_spatial_refuses_before_decoding(tmp_path):
    path = _write_inputs(tmp_path, [(8, 8)])[0]
    with pytest.raises(ValueError, match="unknown preset"):
        serving.process_file_spatial(path, "bogus", mesh=(torch.device("cpu"),))
    with pytest.raises(ValueError, match="duplicate fan-out"):
        serving.process_file_spatial(path, ("enhance", "enhance"), mesh=(torch.device("cpu"),))
    with pytest.raises(ValueError, match="no data to write"):
        serving.process_file_spatial(path, PipelineConfig(), mesh=(torch.device("cpu"),))
    assert os.listdir(tmp_path) == ["in0.ppm"]


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


def test_process_files_spans_carry_each_chunk_id_across_threads(tmp_path):
    """With the reader and writer overlapped over four chunks, each chunk's
    decode (reader), wait and dispatch (main thread) and encode (writer)
    carry that chunk's index as their id; the files written are the bytes of
    a run that records nothing."""
    paths = _write_inputs(tmp_path, [(8, 16)] * 7)
    plain = serving.process_files(paths, "edge_detect", suffix=".plain", max_batch=2)
    with profiling.recording() as rec:
        traced = serving.process_files(paths, "edge_detect", suffix=".traced", max_batch=2)
    for a, b in zip(plain, traced):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert len(traced) == 7
    by_name = collections.defaultdict(dict)
    for s in rec.spans:
        by_name[s.name][s.id] = s
    for name in ("serving.read_decode", "serving.device", "batch.apply", "serving.download",
                 "serving.wait_encode", "serving.encode"):
        assert sorted(by_name[name]) == [0, 1, 2, 3], name
    # and a fifth wait, for the reader's end, under a fresh id
    assert len(by_name["serving.wait_decode"]) == 5
    assert set(by_name["serving.wait_decode"]) >= {0, 1, 2, 3}
    for k in range(4):
        threads = {by_name[n][k].thread for n in
                   ("serving.read_decode", "serving.wait_decode", "serving.encode")}
        assert len(threads) == 3
        assert by_name["batch.apply"][k].parent == by_name["serving.device"][k].seq
        assert by_name["serving.read_decode"][k].end <= by_name["serving.wait_decode"][k].end
        assert by_name["serving.device"][k].end <= by_name["serving.encode"][k].start
    assert rec.dropped == 0


def test_serve_ok_line_carries_the_graph_counters(tmp_path, capsys, monkeypatch):
    """``serve_ok`` gives what the run added to the graph counters, and to
    the dispatch plans made and taken: 0 each on the CPU, where no graph is
    captured and no batch lies on a card."""
    monkeypatch.setenv("IPT_STRUCTURED_LOG", "1")
    paths = _write_inputs(tmp_path, [(8, 16)] * 3)
    assert serve.main(["--preset", "thumbnail", *paths]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().err.splitlines()
             if line.startswith("{")]
    (ok,) = [line for line in lines if line["event"] == "serve_ok"]
    assert ok["n_files"] == 3
    names = ("graphs_captured", "graphs_evicted", "graph_replays", "upload_bytes",
             "dispatch_plans_made", "dispatch_plan_hits")
    assert {k: ok[k] for k in names} == dict.fromkeys(names, 0)


@pytest.mark.parametrize("preset", ["edge_detect", "print_ready"])
def test_serve_ok_line_carries_the_binding_counters(tmp_path, capsys, monkeypatch, preset):
    """``serve_ok`` carries the bindings' counters too: replays that read
    their input and wrote their output where they lie, and bytes copied card
    to card into and out of a graph; 0 each on the CPU, print_ready's packed
    output too."""
    monkeypatch.setenv("IPT_STRUCTURED_LOG", "1")
    paths = _write_inputs(tmp_path, [(8, 16)] * 2)
    assert serve.main(["--preset", preset, *paths]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().err.splitlines()
             if line.startswith("{")]
    (ok,) = [line for line in lines if line["event"] == "serve_ok"]
    names = ("inputs_bound", "outputs_bound", "copy_in_bytes", "copy_out_bytes")
    assert {k: ok[k] for k in names} == dict.fromkeys(names, 0)


def test_serve_ok_line_carries_k1_s_plans_made(tmp_path, capsys, monkeypatch):
    """``serve_ok`` gives what the run added to ``kernels/rotate.py``'s
    ``plans_made`` as ``rotate_plans_made``: one host tile plan for the one
    rotation geometry of three files of one shape (the CPU's plain rotation
    makes it to check its rows)."""
    monkeypatch.setenv("IPT_STRUCTURED_LOG", "1")
    paths = _write_inputs(tmp_path, [(19, 43)] * 3)  # a geometry no other test plans
    assert serve.main(["-r37", *paths]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().err.splitlines()
             if line.startswith("{")]
    (ok,) = [line for line in lines if line["event"] == "serve_ok"]
    assert ok["n_files"] == 3 and ok["rotate_plans_made"] == 1


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
    so = native._build_so()  # in the port's cache directory, not the package's
    assert so is not None and Path(so).parent in cache.cache_dirs()
    assert Path(port_codec).parent not in Path(so).parents
