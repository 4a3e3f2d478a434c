"""Import hygiene of the port: no JAX, no build at import, no hidden CPU fallback."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "imageprocessingtools_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "imageprocessingtools_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert bad == []


def test_forbidden_matcher():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("imageprocessingtools_tpu.ops._exact")
    assert not _forbidden("imageprocessingtools_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


_IMPORT_CHECK = """
import sys
before = set(sys.modules)
import imageprocessingtools_tpu_torch as port
from imageprocessingtools_tpu_torch.kernels import _build
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'imageprocessingtools_tpu'))
assert not bad, bad
assert _build.library.cache_info().currsize == 0, 'the kernels were built or loaded at import'
print('ok')
"""


def test_import_without_cuda_builds_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("IPT_DEVICE", None)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], capture_output=True,
                          text=True, env=env, cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "ok"


def test_device_without_cuda_raises(monkeypatch):
    import torch

    from imageprocessingtools_tpu_torch import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("IPT_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="IPT_DEVICE=cpu"):
        device.get_device()
    monkeypatch.setenv("IPT_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="IPT_DEVICE=cpu"):
        device.get_device()
    monkeypatch.setenv("IPT_DEVICE", "tpu")
    with pytest.raises(RuntimeError, match="IPT_DEVICE must be one of"):
        device.get_device()
    monkeypatch.setenv("IPT_DEVICE", "cpu")
    assert device.get_device() == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_cli_without_cuda_raises_instead_of_using_the_cpu(tmp_path, monkeypatch):
    import torch

    from imageprocessingtools_tpu_torch import cli
    from imageprocessingtools_tpu_torch.codec import ppm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("IPT_DEVICE", raising=False)
    path = str(tmp_path / "x.ppm")
    ppm.write_ppm(path, ppm.decode_ppm(b"P6\n1 1\n255\n\x01\x02\x03")[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-gray", path])
    assert not os.path.exists(path + ".out")


def test_wrappers_refuse_other_devices():
    import torch

    from imageprocessingtools_tpu_torch.kernels import core, rotate

    meta = torch.empty((4, 4, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(TypeError, match="unsupported device"):
        rotate.rotate_bicubic(meta, 30.0)
    with pytest.raises(TypeError, match="unsupported device"):
        core.gray_gauss_hist(meta)
    with pytest.raises(TypeError, match="unsupported device"):
        core.lut_apply(meta, meta)
    for wrapper in (core.histogram, core.gaussian_blur, core.box_blur, core.sharpen,
                    core.sobel):
        with pytest.raises(TypeError, match="unsupported device"):
            wrapper(meta[:, :, 0])
