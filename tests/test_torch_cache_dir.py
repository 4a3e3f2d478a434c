"""Where the port's two builds go (``utils/cache.py``): never into the package.

The order is the JAX codec's (``imageprocessingtools_tpu/codec/native.py::
_cache_dirs``): ``$IPT_CACHE_DIR`` if set, else the checkout's ``.cache/``
where the package's parent holds ``.git``, then ``$XDG_CACHE_HOME`` or
``~/.cache``; each under ``imageprocessingtools_tpu_torch/``. Both the
CUDA kernel library (``kernels/_build.py``) and the C++ codec
(``codec/native.py``) follow it. The codec's g++ is replaced by a stand-in
that writes the output file, so nothing is compiled.
"""

from __future__ import annotations

import subprocess
import types
from pathlib import Path

import pytest

from imageprocessingtools_tpu_torch.codec import native
from imageprocessingtools_tpu_torch.kernels import _build
from imageprocessingtools_tpu_torch.utils import cache

PORT = Path(cache.__file__).resolve().parent.parent
NAME = "imageprocessingtools_tpu_torch"


def _fake_run(cmd, check=False, capture_output=False):
    Path(cmd[cmd.index("-o") + 1]).write_text("a stand-in library\n")
    return subprocess.CompletedProcess(cmd, 0)


@pytest.fixture
def place(tmp_path, monkeypatch):
    """A checkout root without ``.git``, no IPT_CACHE_DIR, and a HOME and an
    XDG_CACHE_HOME of the test's own."""
    root = tmp_path / "checkout"
    root.mkdir()
    monkeypatch.setattr(cache, "ROOT", root)
    monkeypatch.delenv("IPT_CACHE_DIR", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setattr(native, "subprocess", types.SimpleNamespace(
        run=_fake_run, CalledProcessError=subprocess.CalledProcessError))
    return tmp_path


def _built_in(build: str) -> Path:
    """The directory that ``build`` ("kernels" or "codec") puts its library in."""
    if build == "kernels":
        return _build.library_path().parent
    so = native._build_so()
    assert so is not None
    return Path(so).parent


def _expected(where: str, tmp: Path, monkeypatch) -> Path:
    if where == "IPT_CACHE_DIR":
        monkeypatch.setenv("IPT_CACHE_DIR", str(tmp / "env"))
        (tmp / "checkout" / ".git").mkdir()  # the variable wins over a checkout
        return tmp / "env" / NAME
    if where == "checkout with .git":
        (tmp / "checkout" / ".git").mkdir()
        return tmp / "checkout" / ".cache" / NAME
    if where == "no .git: XDG_CACHE_HOME":
        return tmp / "xdg" / NAME
    monkeypatch.delenv("XDG_CACHE_HOME")  # no .git, no XDG_CACHE_HOME: ~/.cache
    return tmp / "home" / ".cache" / NAME


@pytest.mark.parametrize("build", ["kernels", "codec"])
@pytest.mark.parametrize("where", ["IPT_CACHE_DIR", "checkout with .git",
                                   "no .git: XDG_CACHE_HOME", "no .git: ~/.cache"])
def test_build_directory_order(where, build, place, monkeypatch):
    expected = _expected(where, place, monkeypatch)
    assert cache.cache_dirs()[0] == expected
    got = _built_in(build)
    assert got == expected and got.is_dir()
    assert PORT not in got.parents and got != PORT


@pytest.mark.parametrize("build", ["kernels", "codec"])
def test_a_checkout_whose_cache_cannot_be_made_falls_back_to_the_user_cache(build, place):
    (place / "checkout" / ".git").mkdir()
    (place / "checkout" / ".cache").write_text("a file, not a directory\n")
    assert cache.cache_dirs() == [place / "checkout" / ".cache" / NAME, place / "xdg" / NAME]
    assert _built_in(build) == place / "xdg" / NAME


def test_build_dir_raises_when_no_directory_takes_it(place, monkeypatch):
    (place / "blocked").write_text("a file, not a directory\n")
    monkeypatch.setenv("IPT_CACHE_DIR", str(place / "blocked"))
    with pytest.raises(OSError, match="no writable build directory"):
        cache.build_dir()
    assert native._build_so() is None  # the codec then takes the Python codec
