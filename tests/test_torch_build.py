"""The port's kernel build (``kernels/_build.py``) with a stand-in for nvcc.

No CUDA toolkit is needed: a small script takes nvcc's place, writes the
file named by ``-o`` and fails on a source that holds ``#error``. The real
build is exercised on the card by ``chip_smoke.py`` phase 2.
"""

from __future__ import annotations

import stat
import sys

import pytest

from imageprocessingtools_tpu_torch.kernels import _build

_FAKE_NVCC = f"""#!{sys.executable}
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
inputs = [a for a in args if a.endswith((".cu", ".o"))]
for path in inputs:
    if path.endswith(".cu") and "#error" in open(path).read():
        sys.stderr.write(path + ": #error\\n")
        sys.exit(2)
with open(out, "w") as f:
    f.write("\\n".join(inputs))
"""


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    (csrc / "h.cuh").write_text("// header\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    return csrc, build


def test_build_compiles_each_source_and_links_them(fake_tree):
    csrc, build = fake_tree
    out = _build.build()
    assert out == _build.library_path() and out.parent == build
    linked = out.read_text().splitlines()
    assert sorted(p.rsplit("/", 1)[1].split("-")[0] for p in linked) == ["a", "b"]
    assert sorted(p.name for p in build.iterdir()) == [out.name]  # objects removed
    assert _build.build() == out  # reused, not rebuilt


def test_library_name_follows_sources_and_headers(fake_tree):
    csrc, _ = fake_tree
    first = _build.library_path()
    (csrc / "h.cuh").write_text("// changed header\n")
    assert _build.library_path() != first


def test_build_reports_every_failing_source_and_leaves_nothing(fake_tree):
    csrc, build = fake_tree
    (csrc / "b.cu").write_text("#error broken\n")
    with pytest.raises(RuntimeError, match="nvcc failed") as err:
        _build.build()
    assert "b.cu: #error" in str(err.value)
    assert str(err.value).count("nvcc failed") == 1  # a.cu compiled
    assert list(build.iterdir()) == []
