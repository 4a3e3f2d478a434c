"""Build the port's CUDA kernels with nvcc at first use and load them.

Counterpart of the g++ + ctypes loader in
``imageprocessingtools_tpu/codec/native.py``. Every ``csrc/*.cu`` file is
compiled for Hopper (``sm_90a``) by its own nvcc process, all started
together, and the objects are linked into one shared library with a plain C
interface, named by the sha256 of the sources and the headers they include
(``csrc/*.cuh``), under ``build/imageprocessingtools_tpu_torch/`` at the
root of the checkout. The library is loaded with ``ctypes``; no PyTorch
header is compiled, which keeps the build to seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "imageprocessingtools_tpu_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# C entry points: each returns the launch's cudaGetLastError() as an int.
_SIGNATURES = {
    # src, src_row0, src_rows, dst, H, W, C, newH, newW, cos, sin, xc, yc, xoff, yoff, plan,
    # box_w, box_h, device, stream
    "ipt_rotate": [_P, _I, _I, _P, _I, _I, _I, _I, _I, _D, _D, _I, _I, _I, _I, _P, _I, _I, _I,
                   _P],
    # rgb, out, hist, H, W, device, stream
    "ipt_gray_gauss_hist": [_P, _P, _P, _I, _I, _I, _P],
    # rgb, out, H, W, device, stream
    "ipt_gray_gauss": [_P, _P, _I, _I, _I, _P],
    # rgb, out, table (or None for the empty chain), n pixels, device, stream
    "ipt_fused_elementwise": [_P, _P, _P, ctypes.c_longlong, _I, _P],
    # values, out, lut, n, device, stream
    "ipt_lut_apply": [_P, _P, _P, ctypes.c_longlong, _I, _P],
    # values, hist, n, device, stream
    "ipt_histogram": [_P, _P, ctypes.c_longlong, _I, _P],
    # src, out, H, W, device, stream
    "ipt_gaussian_blur": [_P, _P, _I, _I, _I, _P],
    "ipt_box_blur": [_P, _P, _I, _I, _I, _P],
    "ipt_sharpen": [_P, _P, _I, _I, _I, _P],
    "ipt_sobel": [_P, _P, _I, _I, _I, _P],
    # src, dst, idx, w, rows, cols, channels, out_size, taps, dim, vec (dim 0's bytes
    # per thread), device, stream
    "ipt_resize_pass": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _I,
                        ctypes.c_longlong, _I, _I, _I, _I, _P],
    # out (int32[n]), n, device, stream: Sobel's clipped root of 0..n-1 (a test entry)
    "ipt_sobel_out_test": [_P, _I, _I, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libipt_kernels-{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH)")


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [out.parent / f"{src.stem}-{tag}.o" for src in sources()]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    jobs = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objs)]
    try:
        with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc per source, together
            _run_all(list(pool.map(_run, jobs)))
        _run_all([_run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)])])
        os.replace(tmp, out)
    finally:
        for obj in [*objs, tmp]:
            obj.unlink(missing_ok=True)
    return out


def _run(cmd: list[str]) -> tuple:
    return cmd, subprocess.run(cmd, capture_output=True, text=True)


def _run_all(results: list[tuple]) -> None:
    errors = [f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
              for cmd, proc in results if proc.returncode != 0]
    if errors:
        raise RuntimeError("\n".join(errors))


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ipt_error_string.argtypes = [_I]
    lib.ipt_error_string.restype = ctypes.c_char_p
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        text = library().ipt_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} at launch: {text}")
