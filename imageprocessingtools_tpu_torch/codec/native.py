"""ctypes bindings for the native C++ batch codec.

Counterpart of ``imageprocessingtools_tpu/codec/native.py``, with the same
API and messages. It builds the JAX package's source,
``imageprocessingtools_tpu/codec/csrc/ppmcodec.cpp``, by its path (there is
one copy of the C++), with g++ at first use into
``build/imageprocessingtools_tpu_torch/`` at the root of the checkout. Every
entry point falls back to the port's pure-Python codec (``codec/ppm.py``)
where the library cannot be built, for example on a machine without g++: it
is a host codec, and both give the same bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from imageprocessingtools_tpu_torch.codec import ppm as _py

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "imageprocessingtools_tpu" / "codec" / "csrc" / "ppmcodec.cpp"
BUILD_DIR = _ROOT / "build" / "imageprocessingtools_tpu_torch"

_ERROR_MESSAGES = {
    -1: "error in getting next token. wrong format.\n",
    -2: "error. invalid file format.\n",
    -3: "error. invalid file format. unable to parse width from input file.\n",
    -4: "error. invalid file format. unable to parse height from input file.\n",
    -5: "error. invalid file format. unable to parse maximum color from input file.\n",
    -6: "Error: unexpected end of file.\n",
    -7: "file format error\n",
    -8: "error. invalid file format.\n",  # batch dims mismatch
    -9: "error. invalid file format.\n",  # >9-digit-char header int (B4)
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_failed = False


def _build_so() -> str | None:
    """Compile ``SOURCE`` unless the library for its content exists; None
    where it cannot be built (no source, no g++, or a compile error)."""
    try:
        tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
        so_path = BUILD_DIR / f"libppmcodec-{tag}.so"
        if not so_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so_path.with_suffix(f".tmp{os.getpid()}")
            subprocess.run(
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp),
                 str(SOURCE), "-pthread"],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so_path)  # atomic against concurrent builds
        return str(so_path)
    except (OSError, subprocess.CalledProcessError):
        return None


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so_path = _build_so()
        if so_path is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError:
            _build_failed = True
            return None
        lib.ppmx_parse_header.restype = ctypes.c_int
        lib.ppmx_parse_header.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.ppmx_parse_header_prefix.restype = ctypes.c_int
        lib.ppmx_parse_header_prefix.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.ppmx_decode_batch.restype = ctypes.c_int
        lib.ppmx_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.c_int,
        ]
        lib.ppmx_decode_batch_files.restype = ctypes.c_int
        lib.ppmx_decode_batch_files.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),    # paths
            ctypes.c_int,                       # n
            ctypes.c_void_p,                    # dst
            ctypes.c_uint32,                    # w
            ctypes.c_uint32,                    # h
            ctypes.POINTER(ctypes.c_int),       # rcs
            ctypes.c_int,                       # nthreads
        ]
        lib.ppmx_pack_bits.restype = None
        lib.ppmx_pack_bits.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_uint32,
            ctypes.c_uint32,
        ]
        lib.ppmx_encode_batch_files.restype = ctypes.c_int
        lib.ppmx_encode_batch_files.argtypes = [
            ctypes.c_void_p,                    # src
            ctypes.c_size_t,                    # stride
            ctypes.c_size_t,                    # payload_bytes
            ctypes.c_int,                       # n
            ctypes.POINTER(ctypes.c_char_p),    # paths
            ctypes.POINTER(ctypes.c_char_p),    # headers
            ctypes.POINTER(ctypes.c_size_t),    # header_lens
            ctypes.POINTER(ctypes.c_int),       # rcs
            ctypes.c_int,                       # nthreads
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def parse_file_header(path: str, prefix_bytes: int = 65536):
    """(width, height, maxval, payload_offset) via the NATIVE lexer over a
    file prefix — the batched serving header pass (4096 files would read
    ~100 GB if slurped whole). Grammar, messages, and the retry-on-straddle
    behavior mirror `codec.ppm.parse_file_header`; falls back to the Python
    implementation when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return _py.parse_file_header(path, prefix_bytes)
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        prefix = f.read(prefix_bytes)
    w = ctypes.c_uint32()
    h = ctypes.c_uint32()
    mv = ctypes.c_uint32()
    off = ctypes.c_size_t()
    rc = lib.ppmx_parse_header_prefix(
        prefix, len(prefix), size,
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(mv), ctypes.byref(off))
    if rc != 0 and len(prefix) < size:
        # Error or header-straddles-prefix on a partial read: retry whole.
        with open(path, "rb") as f:
            data = f.read()
        rc = lib.ppmx_parse_header_prefix(
            data, len(data), size,
            ctypes.byref(w), ctypes.byref(h), ctypes.byref(mv),
            ctypes.byref(off))
    if rc != 0:
        raise _py.PPMError(_ERROR_MESSAGES[rc])
    return w.value, h.value, mv.value, off.value


def parse_header(data: bytes) -> tuple[int, int, int, int]:
    """(width, height, maxval, payload_offset) via the native lexer."""
    lib = _load()
    if lib is None:
        img, maxval = _py.decode_ppm(data)  # fallback: full decode
        return img.shape[1], img.shape[0], maxval, len(data) - img.size
    w = ctypes.c_uint32()
    h = ctypes.c_uint32()
    mv = ctypes.c_uint32()
    off = ctypes.c_size_t()
    rc = lib.ppmx_parse_header(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(mv), ctypes.byref(off))
    if rc != 0:
        raise _py.PPMError(_ERROR_MESSAGES[rc])
    return w.value, h.value, mv.value, off.value


def decode_batch(buffers: list[bytes], n_threads: int | None = None) -> tuple[np.ndarray, int]:
    """Decode N same-shape P6 buffers to uint8[N, H, W, 3] in parallel.

    Returns (batch, maxval_of_first). Falls back to the Python codec when
    the native library is unavailable.
    """
    if not buffers:
        raise _py.PPMError("Error: no data to write\n")
    lib = _load()
    if lib is None:
        imgs = []
        maxval = 255
        for i, buf in enumerate(buffers):
            img, mv = _py.decode_ppm(buf)
            if i == 0:
                maxval = mv
            imgs.append(img)
        return np.stack(imgs), maxval

    w, h, maxval, _ = parse_header(buffers[0])
    n = len(buffers)
    out = np.empty((n, h, w, 3), dtype=np.uint8)
    arr_t = ctypes.c_char_p * n
    size_t_arr = ctypes.c_size_t * n
    datas = arr_t(*buffers)
    sizes = size_t_arr(*[len(b) for b in buffers])
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    rc = lib.ppmx_decode_batch(
        datas, sizes, n, out.ctypes.data_as(ctypes.c_void_p), w, h, n_threads
    )
    if rc != 0:
        raise _py.PPMError(_ERROR_MESSAGES[rc])
    return out, maxval


def decode_batch_files(
    paths: list[str],
    h: int,
    w: int,
    n_threads: int | None = None,
) -> tuple[np.ndarray, dict[int, tuple[str, str]]]:
    """Decode N same-shape P6 FILES to uint8[N, H, W, 3], payloads pread()
    directly into the output tensor.

    The file-native twin of ``decode_batch``: where that takes already-read
    ``bytes`` (page cache -> Python bytes -> memcpy, two full passes plus a
    Python read loop), this hands the paths to the C++ side which preads
    each payload straight into its row of the batch — one copy, no
    intermediate buffers, threads overlapping I/O stalls (the reference
    decodes one image per process with a getc() loop,
    ``ppmx-edward.c:303-330``).

    Returns ``(batch, failures)`` where ``failures`` maps input index ->
    ``(kind, message)`` with ``kind`` in ``{"open", "ppm"}`` and ``message``
    the stdout-parity surface; rows of failed files are undefined. A file
    whose header dims disagree with ``(h, w)`` fails with the invalid-format
    message (the caller's bucket shape is the header pass's claim). Falls
    back to per-file Python reads + codec without a toolchain.
    """
    n = len(paths)
    out = np.empty((n, h, w, 3), dtype=np.uint8)
    failures: dict[int, tuple[str, str]] = {}
    lib = _load()
    if lib is None:
        for i, p in enumerate(paths):
            try:
                with open(p, "rb") as f:
                    img, _ = _py.decode_ppm(f.read())
            except OSError:
                failures[i] = ("open", "error. can not open file\n")
                continue
            except _py.PPMError as e:
                failures[i] = ("ppm", e.message)
                continue
            if img.shape[:2] != (h, w):
                failures[i] = ("ppm", "error. invalid file format.\n")
                continue
            out[i] = img
        return out, failures
    path_arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rcs = (ctypes.c_int * n)()
    if n_threads is None:
        # I/O-bound like the batch encoder: threads overlap read stalls
        # even with few cores (see encode_batch_files).
        n_threads = min(16, n)
    lib.ppmx_decode_batch_files(
        path_arr, n, out.ctypes.data_as(ctypes.c_void_p), w, h, rcs, n_threads
    )
    for i in range(n):
        rc = rcs[i]
        if rc == -10:
            failures[i] = ("open", "error. can not open file\n")
        elif rc != 0:
            failures[i] = ("ppm", _ERROR_MESSAGES.get(rc, _ERROR_MESSAGES[-2]))
    return out, failures


def encode_batch_files(
    out_paths: list[str],
    batch: np.ndarray,
    file_type: int,
    max_colors: list[int],
    p4_dims: tuple[int, int] | None = None,
    n_threads: int | None = None,
) -> None:
    """Write N same-shape images to files in parallel via the native encoder.

    The write-side twin of ``decode_batch`` (the reference encoder,
    ``ppmx-edward.c:221-301``, is 1 byte per fwrite, one image per process;
    this writes header+payload as two full buffers per file, threaded across
    files). ``batch`` is uint8 ``[N, H, W, 3]`` (P6), ``[N, H, W]`` (P5), or
    — with ``p4_dims=(height, width)`` for the header — already-packed P4
    rows ``[N, H, row_bytes]``. ``max_colors`` is the per-file pass-through
    maxval (B5). Byte-identical outputs to ``ppm.encode_ppm``; falls back to
    a sequential ``ppm.write_ppm`` loop without a toolchain. Raises
    ``PPMError`` (write_ppm's surface) on the first open/write failure.
    """
    n = len(out_paths)
    if n == 0:
        return
    batch = np.ascontiguousarray(batch, dtype=np.uint8)
    if batch.shape[0] != n or len(max_colors) != n:
        raise ValueError("encode_batch_files: path/batch/maxval length mismatch")
    if p4_dims is not None:
        hh, ww = p4_dims
        headers = [_py.ppm_header(file_type, ww, hh, 255) for _ in range(n)]
    else:
        hh, ww = batch.shape[1], batch.shape[2]
        headers = [
            _py.ppm_header(file_type, ww, hh, mv) for mv in max_colors
        ]
    lib = _load()
    if lib is None:
        for path, header, img in zip(out_paths, headers, batch):
            try:
                with open(path, "wb") as f:
                    f.write(header)
                    f.write(img.data)
            except OSError:
                raise _py.PPMError("Error: unable to open file for writing\n")
        return
    payload_bytes = batch[0].nbytes
    path_arr = (ctypes.c_char_p * n)(*[p.encode() for p in out_paths])
    header_arr = (ctypes.c_char_p * n)(*headers)
    len_arr = (ctypes.c_size_t * n)(*[len(h) for h in headers])
    rcs = (ctypes.c_int * n)()
    if n_threads is None:
        # Not tied to cpu_count: the writers are I/O-bound (page-cache
        # writes that stall on writeback), so extra threads overlap stalls
        # even with few cores.
        n_threads = min(16, n)
    rc = lib.ppmx_encode_batch_files(
        batch.ctypes.data_as(ctypes.c_void_p),
        payload_bytes,
        payload_bytes,
        n,
        path_arr,
        header_arr,
        len_arr,
        rcs,
        n_threads,
    )
    if rc != 0:
        raise _py.PPMError("Error: unable to open file for writing\n")


def pack_bits(bits: np.ndarray) -> bytes:
    """P4 payload packing via the native kernel (np.packbits-equivalent)."""
    lib = _load()
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    if lib is None:
        return np.packbits(bits, axis=1).tobytes()
    h, w = bits.shape
    out = np.empty((h, (w + 7) // 8), dtype=np.uint8)
    lib.ppmx_pack_bits(
        bits.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        w,
        h,
    )
    return out.tobytes()
