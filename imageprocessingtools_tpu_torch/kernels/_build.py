"""Build the port's CUDA kernels with nvcc at first use and load them.

Counterpart of the g++ + ctypes loader in
``imageprocessingtools_tpu/codec/native.py``. Every ``csrc/*.cu`` file is
compiled for Hopper (``sm_90a``) by its own nvcc process, all started
together, and the objects are linked into one shared library with a plain C
interface, named by the sha256 of the sources and the headers they include
(``csrc/*.cuh``), in the port's cache directory (``utils/cache.py``:
``$IPT_CACHE_DIR``, the checkout's ``.cache/``, or the user's cache, never
the package's own directory). The library is loaded with ``ctypes``; no
PyTorch header is compiled, which keeps the build to seconds.

The C entry points take the image's dimensions as C ints and compute every
offset into an image in 64 bits, so an image of 2^31 bytes or more is one
launch. ``int_limit`` and the wrappers' own limit functions say where a
launch stops; a wrapper refuses a larger tensor with ``TooLarge``.
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

import torch

from imageprocessingtools_tpu_torch.utils import cache

CSRC = Path(__file__).resolve().parent.parent / "csrc"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

INT_MAX = 2**31 - 1
# Bytes past a row's end that a kernel's int column arithmetic reaches: a
# tile's width and its halo, with room to spare.
ROW_SLACK = 1024


class TooLarge(RuntimeError, MemoryError):
    """A kernel's launch cannot take a tensor this large. A ``RuntimeError``
    for callers that expect one, and a ``MemoryError``, so that the CLI's and
    ``serve``'s backstops answer it as the C answers a failed allocation."""


def int_limit(rows: int, row_bytes: int) -> str | None:
    """Why a kernel that indexes rows and a row's bytes with C ints cannot
    take ``rows`` rows of ``row_bytes`` bytes, or None when it can."""
    if rows > INT_MAX:
        return f"{rows} rows do not fit a C int"
    if row_bytes + ROW_SLACK > INT_MAX:
        return f"a row of {row_bytes} bytes does not fit a C int"
    return None


def image_channels(name: str, img: torch.Tensor, ndim: int) -> int:
    """The channels of ``img``, a contiguous uint8 tensor on a CUDA device
    with ``ndim`` axes (``ndim + 1`` with the channels, 1 or 3): what K1's
    and K9's launches take. Raises ``TypeError`` on anything else."""
    if img.device.type != "cuda":
        raise TypeError(f"{name}: unsupported device {img.device}")
    if img.dtype != torch.uint8 or img.ndim not in (ndim, ndim + 1) or not img.is_contiguous():
        raise TypeError(
            f"{name}: need a contiguous uint8[{'N, ' * (ndim - 2)}H, W(, C)] tensor, got "
            f"{img.dtype} {tuple(img.shape)} contiguous={img.is_contiguous()}")
    c = 1 if img.ndim == ndim else img.shape[-1]
    if c not in (1, 3):
        raise TypeError(f"{name}: the kernel takes 1 or 3 channels, got {c}")
    return c


_P, _I, _U, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_double
# C entry points: each returns the launch's cudaGetLastError() as an int.
_SIGNATURES = {
    # src, src_row0, src_rows, dst, H, W, C, newH, newW, cos, sin, xc, yc, xoff, yoff, plan,
    # box_w, box_h, device, stream
    "ipt_rotate": [_P, _I, _I, _P, _I, _I, _I, _I, _I, _D, _D, _I, _I, _I, _I, _P, _I, _I, _I,
                   _P],
    # src, dst, N, H, W, C, newH, newW, cos, sin, xc, yc, xoff, yoff, plan, box_w, box_h,
    # device, stream
    "ipt_rotate_batch": [_P, _P, _I, _I, _I, _I, _I, _I, _D, _D, _I, _I, _I, _I, _P, _I, _I,
                         _I, _P],
    # rgb, out, hist, H, W, device, stream
    "ipt_gray_gauss_hist": [_P, _P, _P, _I, _I, _I, _P],
    # rgb, out, H, W, device, stream
    "ipt_gray_gauss": [_P, _P, _I, _I, _I, _P],
    # the batch forms: rgb, out, (hist,) N, H, W, device, stream
    "ipt_gray_gauss_hist_batch": [_P, _P, _P, _I, _I, _I, _I, _P],
    "ipt_gray_gauss_batch": [_P, _P, _I, _I, _I, _I, _P],
    # rgb, out, table (or None for the empty chain), n pixels, device, stream
    "ipt_fused_elementwise": [_P, _P, _P, ctypes.c_longlong, _I, _P],
    # values, out, lut, n, device, stream
    "ipt_lut_apply": [_P, _P, _P, ctypes.c_longlong, _I, _P],
    # values, out, luts, N, n per image, device, stream
    "ipt_lut_apply_batch": [_P, _P, _P, _I, ctypes.c_longlong, _I, _P],
    # gray, out, N, H, W, the four words of the Bayer thresholds (byte x % 4 of word y % 4),
    # device, stream
    "ipt_dither_pack_batch": [_P, _P, _I, _I, _I, _U, _U, _U, _U, _I, _P],
    # values, hist, n, device, stream, arrival words (or None for the stream's own)
    "ipt_histogram": [_P, _P, ctypes.c_longlong, _I, _P, _P],
    # values, hist, N, n per image, device, stream, N times the arrival words
    "ipt_histogram_batch": [_P, _P, _I, ctypes.c_longlong, _I, _P, _P],
    # (): the number of 64-bit arrival words a K4 launch uses
    "ipt_histogram_arrival_words": [],
    # src, out, H, W, device, stream
    "ipt_gaussian_blur": [_P, _P, _I, _I, _I, _P],
    "ipt_box_blur": [_P, _P, _I, _I, _I, _P],
    "ipt_sharpen": [_P, _P, _I, _I, _I, _P],
    "ipt_sobel": [_P, _P, _I, _I, _I, _P],
    # src, out, N, H, W, device, stream
    "ipt_box_blur_batch": [_P, _P, _I, _I, _I, _I, _P],
    "ipt_sharpen_batch": [_P, _P, _I, _I, _I, _I, _P],
    "ipt_sobel_batch": [_P, _P, _I, _I, _I, _I, _P],
    # src, dst, idx, w, rows, cols, channels, out_size, taps, dim, vec (dim 0's bytes
    # per thread), device, stream
    "ipt_resize_pass": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _I,
                        ctypes.c_longlong, _I, _I, _I, _I, _P],
    # the same with N images first: src, dst, idx, w, N, rows, cols, ...
    "ipt_resize_pass_batch": [_P, _P, _P, _P, _I, ctypes.c_longlong, ctypes.c_longlong, _I,
                              ctypes.c_longlong, _I, _I, _I, _I, _P],
    # cols, channels, out_size, taps, device, tiled (int*): the W pass's planned path
    "ipt_resize_cols_tiled": [ctypes.c_longlong, _I, ctypes.c_longlong, _I, _I, _P],
    # out (int32[n]), n, device, stream: Sobel's clipped root of 0..n-1 (a test entry)
    "ipt_sobel_out_test": [_P, _I, _I, _P],
    # CUDA graphs' notes and bindings (csrc/launch.cuh, utils/graphs.py):
    # stream, the id of its capture underway (out)
    "ipt_capture_id": [_P, ctypes.POINTER(ctypes.c_ulonglong)],
    # capture id, its notes (out)
    "ipt_capture_note_count": [ctypes.c_ulonglong, ctypes.POINTER(_I)],
    # capture id, notes (out), at most this many
    "ipt_capture_notes_take": [ctypes.c_ulonglong, _P, _I],
    # a kept dispatch of an instantiated graph (out, last): the graph, bindings, then per
    # binding: node, its kernel's arguments, the argument's index, its buffer (0 the input,
    # 1 the output), its byte offset there; the graph's own input and output
    "ipt_dispatch_new": [_P, _I, _P, _P, _P, _P, _P, ctypes.c_ulonglong, ctypes.c_ulonglong,
                         ctypes.POINTER(_P)],
    "ipt_dispatch_free": [_P],
    # dispatch, stream, input, output, the graph's event, steps (wait 1, launch 2, record 4)
    "ipt_graph_dispatch": [_P, _P, ctypes.c_ulonglong, ctypes.c_ulonglong, _P, _I],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return cache.build_dir() / f"libipt_kernels-{digest.hexdigest()[:16]}.so"


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
