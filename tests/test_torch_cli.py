"""The port's CLI and pipeline as a whole (the slice end to end, on the CPU).

Held against, in turn:

- the numpy golden model (verified byte-identical to the C binary by
  tests/test_golden_vs_c.py): every flag set byte-identical, resize chains
  included (rotation and resize are f64 in the C's order: the port has no
  inexact stage and no budget);
- the C binary itself through ``ref_runner`` (skips where the oracle cannot
  be built): the same flag sets byte-identical, and exit code + stdout on
  the probe set;
- the JAX CLI: exit code + stdout on the probe set, and the B1 combos
  (``-gray -fv``, ``-mono -fh``...), where the C emits garbage by design and
  the port, like JAX, composes;
- JAX ``run_pipeline``: exact configs byte-identical; configs with arbitrary
  rotation or resize within JAX's own ``float_stage_budget`` of the chain
  (the inexact side is JAX's float32 device path).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu import cli as jax_cli
from imageprocessingtools_tpu import pipeline as jax_pipeline
from imageprocessingtools_tpu.codec import ppm as jax_ppm
from imageprocessingtools_tpu.golden import model as golden
from imageprocessingtools_tpu.ops.common import float_stage_budget as jax_budget
from imageprocessingtools_tpu_torch import cli, pipeline
from tests.conftest import SHAPES, make_gradient, make_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXACT_FLAGS = [
    ["-gray"], ["-mono"], ["-fv"], ["-fh"],
    ["-r0"], ["-r90"], ["-r180"], ["-r270"], ["-r30"], ["-r135"],
    ["-r30", "-gray"], ["-r135", "-mono", "-fh"], ["-r90", "-mono"],
]
RESIZE_FLAGS = [
    ["-w32"], ["-w10"], ["-w24", "-gray"], ["-w10", "-mono"], ["-gray", "-w10"],
    ["-w32", "-r30", "-gray", "-fh"], ["-w20", "-r45", "-gray", "-fh"],
]
B1_FLAGS = [["-gray", "-fv"], ["-mono", "-fh"], ["-gray", "-fh"], ["-mono", "-fv"]]

_P6 = jax_ppm.encode_ppm(make_image(4, 4))
PROBES = {
    "no_flags": (_P6, []),
    "wx5": (_P6, ["-wx5"]),
    "zap": (_P6, ["-zap"]),
    "p5_input": (b"P5\n2 2\n255\n" + b"\x00" * 4, ["-gray"]),
    "truncated": (_P6[:-5], ["-gray"]),
    "trailing_byte": (_P6 + b"\x00", ["-gray"]),
    "degenerate_height": (jax_ppm.encode_ppm(make_image(4, 18)), ["-w2"]),
    "huge_resize": (jax_ppm.encode_ppm(make_image(200, 10)), ["-w999999999"]),
}
# The argument errors of tests/test_cli.py::ARG_ERROR_CASES.
for _args in (["-fh", "-fh"], ["-fv", "-fv"], ["-fh", "-fv"], ["-fx"], ["-f"],
              ["-w12x"], ["-w10", "-w20"], ["-r"], ["-r45x"], ["-r360"],
              ["-r30", "-r60"], ["-gray", "-gray"], ["-gray", "-mono"],
              ["-mono", "-gray"], ["-bogus"], ["-w0"], ["-w"], ["-r4294967295"],
              ["-w" + "9" * 30]):
    PROBES[" ".join(_args)] = (_P6, _args)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPT_DEVICE", "cpu")


def _run(main, tmp_path, data, args, capsys, name):
    """Run a CLI ``main`` on ``data`` written to ``name``: (exit, stdout, .out)."""
    path = os.path.join(str(tmp_path), name)
    with open(path, "wb") as f:
        f.write(data)
    code = main(args + [path])
    stdout = capsys.readouterr().out
    out = None
    if os.path.exists(path + ".out"):
        with open(path + ".out", "rb") as f:
            out = f.read()
        os.remove(path + ".out")
    os.remove(path)
    return code, stdout, out


def _golden_chain(img: np.ndarray, args: list[str]) -> bytes:
    """The reference's fixed order on the golden model, encoded."""
    flags = set(args)
    out = img
    for a in args:
        if a.startswith("-w"):
            out = golden.resize_width(out, int(a[2:]))
    for a in args:
        if a.startswith("-r"):
            out = golden.rotate(out, float(a[2:]))
    file_type = jax_ppm.FILETYPE_PPM
    if "-gray" in flags:
        out, file_type = golden.grayscale(out), jax_ppm.FILETYPE_PGM
    if "-mono" in flags:
        out, file_type = golden.mono_dither(out), jax_ppm.FILETYPE_PBM
    if "-fv" in flags:
        out = golden.flip_vertical(out)
    if "-fh" in flags:
        out = golden.flip_horizontal(out)
    return jax_ppm.encode_ppm(out, file_type)


def _payload_diff(a: bytes, b: bytes) -> int:
    """Max |a - b| over two encoded outputs whose headers must match."""
    a_img, _, a_type = jax_ppm.decode_pnm(a)
    b_img, _, b_type = jax_ppm.decode_pnm(b)
    assert a_type == b_type and a_img.shape == b_img.shape
    return int(np.abs(a_img.astype(np.int64) - b_img.astype(np.int64)).max(initial=0))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("args", EXACT_FLAGS, ids=" ".join)
def test_exact_flags_byte_identical_to_golden(tmp_path, capsys, args, shape):
    img = make_image(*shape)
    code, stdout, out = _run(cli.main, tmp_path, jax_ppm.encode_ppm(img), args, capsys, "in.ppm")
    assert (code, stdout) == (0, "")
    assert out == _golden_chain(img, args)


@pytest.mark.parametrize("make", [make_gradient, make_image], ids=["gradient", "noise"])
@pytest.mark.parametrize("args", RESIZE_FLAGS, ids=" ".join)
def test_resize_chains_within_budget_of_golden(tmp_path, capsys, args, make):
    img = make(16, 12) if make is make_gradient else make(48, 64)
    code, stdout, out = _run(cli.main, tmp_path, jax_ppm.encode_ppm(img), args, capsys, "in.ppm")
    assert (code, stdout) == (0, "")
    exp = _golden_chain(img, args)
    assert out.split(b"\n", 3)[:3] == exp.split(b"\n", 3)[:3]
    assert _payload_diff(out, exp) == 0  # the budget is 0: resize is exact
    assert out == exp


@pytest.mark.parametrize("args", EXACT_FLAGS + RESIZE_FLAGS, ids=" ".join)
def test_flags_match_c_binary(ref_runner, tmp_path, capsys, args):
    for shape in SHAPES:
        img = make_gradient(*shape)
        data = jax_ppm.encode_ppm(img)
        ref = ref_runner.run(data, args)
        ours = _run(cli.main, tmp_path, data, args, capsys, "c.ppm")
        assert ours[:2] == ref[:2], (shape, ours[1], ref[1])
        assert ours[2] == ref[2], shape


@pytest.mark.parametrize("name", PROBES)
def test_probe_matches_jax_cli(tmp_path, capsys, name):
    data, args = PROBES[name]
    ours = _run(cli.main, tmp_path, data, args, capsys, "p.ppm")
    theirs = _run(jax_cli.main, tmp_path, data, args, capsys, "p.ppm")
    assert ours == theirs
    assert ours[0] == 255 and ours[2] is None


@pytest.mark.parametrize("name", PROBES)
def test_probe_matches_c_binary(ref_runner, tmp_path, capsys, name):
    data, args = PROBES[name]
    ref = ref_runner.run(data, args)
    ours = _run(cli.main, tmp_path, data, args, capsys, "p.ppm")
    assert ours == ref


def test_argv_only_probes_match_jax_cli(tmp_path, capsys):
    missing = str(tmp_path / "missing.ppm")
    for argv in ([], ["-gray", missing], ["-gray", "a.ppm", "b.ppm"]):
        code = cli.main(argv)
        stdout = capsys.readouterr().out
        assert (code, stdout) == (jax_cli.main(argv), capsys.readouterr().out), argv
        assert code == 255


@pytest.mark.parametrize("args", B1_FLAGS, ids=" ".join)
def test_b1_combos_match_jax_cli(tmp_path, capsys, args):
    data = jax_ppm.encode_ppm(make_image(13, 17))
    ours = _run(cli.main, tmp_path, data, args, capsys, "b1.ppm")
    theirs = _run(jax_cli.main, tmp_path, data, args, capsys, "b1.ppm")
    assert ours[0] == 0 and ours == theirs


PIPELINE_CONFIGS = [
    dict(gray=True), dict(mono=True, flip_v=True), dict(angle=90.0, flip_h=True),
    dict(angle=30.0), dict(angle=117.0, gray=True), dict(angle=245.0, mono=True),
    dict(new_width=40), dict(new_width=17, angle=135.0, gray=True, flip_v=True),
]


@pytest.mark.parametrize("kw", PIPELINE_CONFIGS, ids=lambda kw: ",".join(kw))
def test_run_pipeline_matches_jax(kw):
    img = make_image(29, 41, seed=len(kw))
    out, file_type = pipeline.run_pipeline(img, pipeline.PipelineConfig(**kw))
    exp, exp_type = jax_pipeline.run_pipeline(img, jax_pipeline.PipelineConfig(**kw))
    exp = np.asarray(exp)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert file_type == exp_type and tuple(out.shape) == exp.shape
    has_rot = kw.get("angle") not in (None, 0.0, 90.0, 180.0, 270.0)
    bound = jax_budget("new_width" in kw, has_rot)
    assert np.abs(out.numpy().astype(np.int64) - exp.astype(np.int64)).max() <= bound


def test_run_pipeline_no_op_is_b2():
    with pytest.raises(ValueError, match="no data to write"):
        pipeline.run_pipeline(make_image(4, 4), pipeline.PipelineConfig())


def test_module_entry_point_in_subprocess(tmp_path):
    img = make_image(23, 31, seed=7)
    path = str(tmp_path / "sub.ppm")
    jax_ppm.write_ppm(path, img)
    env = dict(os.environ, IPT_DEVICE="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "imageprocessingtools_tpu_torch.cli", "-r30", "-mono", path],
        capture_output=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(path + ".out", "rb") as f:
        assert f.read() == _golden_chain(img, ["-r30", "-mono"])
