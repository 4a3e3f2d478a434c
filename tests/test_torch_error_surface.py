"""The C's allocation-failure surface for card errors and kernel size refusals.

The C prints "error. allocating indices" on stdout and exits 255 where an
allocation fails (``ppmx-edward.c:31-36``). The port's ``cli.main`` and
``serve.main`` must do the same for a host ``MemoryError``, for the card's
``torch.OutOfMemoryError`` and for a kernel's refusal of a tensor too large
for its launch (``kernels.TooLarge``). A failed launch (``_build.check``) is
none of these: it must stay an exception, which ends the process with a
traceback and a non-zero exit. The errors are injected into the pipeline
with monkeypatch; everything else runs on the CPU.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from imageprocessingtools_tpu_torch import cli, kernels, serve, serving
from imageprocessingtools_tpu_torch.codec import ppm
from imageprocessingtools_tpu_torch.kernels import _build, core
from imageprocessingtools_tpu_torch.ops import _exact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _too_large():
    # The wrappers' own refusal, with a limit that refuses everything.
    core._refuse("sobel", torch.empty((4, 4), dtype=torch.uint8), lambda h, w: "a test limit")


def _out_of_memory():
    raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 4.08 GiB")


def _host_memory():
    raise MemoryError()


class _Library:
    """Stands in for the kernel library: only the error text is read."""

    @staticmethod
    def ipt_error_string(status):
        return b"an illegal memory access was encountered"


def _launch_failure():
    _build.check(700, "ipt_rotate")


ALLOCATION_ERRORS = {"card_out_of_memory": _out_of_memory, "kernel_too_large": _too_large,
                     "host_memory": _host_memory}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPT_DEVICE", "cpu")
    monkeypatch.setattr(_build, "library", lambda: _Library())


@pytest.fixture
def p6(tmp_path):
    path = str(tmp_path / "in.ppm")
    ppm.write_ppm(path, np.random.default_rng(5).integers(0, 256, (6, 8, 3), dtype=np.uint8))
    return path


def _raiser(error):
    def fn(*args, **kwargs):
        error()
    return fn


def test_too_large_is_a_runtime_and_a_memory_error():
    assert kernels.TooLarge is _build.TooLarge
    assert issubclass(kernels.TooLarge, RuntimeError)
    assert issubclass(kernels.TooLarge, MemoryError)
    with pytest.raises(kernels.TooLarge, match="sobel: 4x4 is too large: a test limit"):
        _too_large()


@pytest.mark.parametrize("error", list(ALLOCATION_ERRORS))
def test_cli_prints_the_allocation_message(error, p6, monkeypatch, capsys):
    monkeypatch.setattr(cli, "run_pipeline", _raiser(ALLOCATION_ERRORS[error]))
    assert cli.main(["-r30", p6]) == 255
    assert capsys.readouterr().out == _exact.B9_MESSAGE
    assert not os.path.exists(p6 + ".out")


@pytest.mark.parametrize("mode", ["batch", "spatial"])
@pytest.mark.parametrize("error", list(ALLOCATION_ERRORS))
def test_serve_prints_the_allocation_message(error, mode, p6, monkeypatch, capsys):
    entry = "process_files" if mode == "batch" else "process_file_spatial"
    monkeypatch.setattr(serving, entry, _raiser(ALLOCATION_ERRORS[error]))
    flags = ["--spatial"] if mode == "spatial" else []
    assert serve.main([*flags, "--preset", "edge_detect", p6]) == 255
    assert capsys.readouterr().out == _exact.B9_MESSAGE


def test_cli_lets_a_failed_launch_raise(p6, monkeypatch, capsys):
    monkeypatch.setattr(cli, "run_pipeline", _raiser(_launch_failure))
    with pytest.raises(RuntimeError, match="ipt_rotate: CUDA error 700 at launch") as err:
        cli.main(["-r30", p6])
    assert not isinstance(err.value, MemoryError)
    assert _exact.B9_MESSAGE not in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["batch", "spatial"])
def test_serve_lets_a_failed_launch_raise(mode, p6, monkeypatch, capsys):
    entry = "process_files" if mode == "batch" else "process_file_spatial"
    monkeypatch.setattr(serving, entry, _raiser(_launch_failure))
    flags = ["--spatial"] if mode == "spatial" else []
    with pytest.raises(RuntimeError, match="CUDA error 700 at launch"):
        serve.main([*flags, "--preset", "edge_detect", p6])
    assert _exact.B9_MESSAGE not in capsys.readouterr().out


_PROCESS = textwrap.dedent("""
    import sys
    from imageprocessingtools_tpu_torch import {module}
    from imageprocessingtools_tpu_torch.kernels import _build, core
    import torch

    class Library:
        @staticmethod
        def ipt_error_string(status):
            return b"an illegal memory access was encountered"

    def fail(*args, **kwargs):
        if sys.argv[1] == "launch":
            _build.check(700, "ipt_rotate")
        core._refuse("sobel", torch.empty((4, 4), dtype=torch.uint8), lambda h, w: "a test limit")

    _build.library = lambda: Library()
    {patch}
    sys.exit({module}.main(sys.argv[2:]))
""")


@pytest.mark.parametrize("module", ["cli", "serve"])
def test_the_process_exits_255_or_with_a_traceback(module, p6):
    """The process as a user runs it: a size refusal exits 255 with the
    message, a failed launch exits non-zero with its traceback."""
    patch = ("cli.run_pipeline = fail" if module == "cli"
             else "serve.serving.process_files = fail")
    code = _PROCESS.format(module=module, patch=patch)
    args = ["-r30", p6] if module == "cli" else ["--preset", "edge_detect", p6]
    env = dict(os.environ, IPT_DEVICE="cpu")
    runs = {kind: subprocess.run([sys.executable, "-c", code, kind, *args], cwd=REPO, env=env,
                                 capture_output=True, text=True, timeout=300)
            for kind in ("too_large", "launch")}
    assert runs["too_large"].returncode == 255
    assert runs["too_large"].stdout == _exact.B9_MESSAGE
    assert runs["launch"].returncode not in (0, 255)
    assert "Traceback" in runs["launch"].stderr
    assert "CUDA error 700 at launch" in runs["launch"].stderr
    assert _exact.B9_MESSAGE not in runs["launch"].stdout
