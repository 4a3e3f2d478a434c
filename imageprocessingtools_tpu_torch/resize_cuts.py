"""Time cuts of K9 on one CUDA card: the kernel with one part taken out.

Run from the root of the repository, with one CUDA card:

    python -m imageprocessingtools_tpu_torch.resize_cuts [CUT[,CUT...] ...]

No profiler with stall reasons works on the card machine, so this is how
K9's time is taken apart: each cut is a textual change to a copy of
``csrc/resize.cu`` (``CUTS``: the lines taken out or replaced), built with
nvcc (the kernel library's flags) into its own shared library in the port's
cache directory (``utils/cache.py``). A cut kernel gives wrong bytes; only its time is read. For each
cut, or comma-joined set of cuts, given on the command line (default: every
single cut and a few sets) it prints one JSON object: the ms per launch of
each pass (CUDA events around 30 back-to-back launches, median of 5) at
4K -> 1920 RGB, 4K -> 256 RGB, 4K gray -> 1920 and 1080p -> 3840 RGB, and
the W pass of ten 4K images -> 1920 and -> 256. The
launches are made through ctypes in a tight loop; where a pass takes less
than about 0.012 ms the number is the host's launch rate, not the card's.
``base`` is the uncut source, whose bytes are checked against the plain
version.

``stamps`` is not a cut: it builds the whole kernel with ``%globaltimer``
reads in the W pass (dim 1) at each block's start, after its first group's
tables, when its first and second tile's rows have landed, after the first
tile's sums and stores, and at its end, runs each case's W pass once (after
two warm-up launches) and prints, per case, the least, median and largest
time of every stamp over the blocks, in us from the first block's start.

What the cuts can and cannot show: ``no_f64`` replaces a tap's two f64
operations (the fused product and the sum) by integer ones, which issue at the
same rate (16 lanes a cycle and scheduler), so it shows whether the FP64
unit's latency matters, not what the operations cost to issue.
``no_conversion`` drops the fused product's exact addend: the product becomes
a DMUL of the byte's bits under 2^52's exponent (wrong bytes); the W pass's
tiled sums read the addend from a staged table (the H pass and the gathered
sums form it by a DMUL a tap), so there it shows what the addend's operand
costs. ``no_table_loads`` makes the tiled sums' weights and addends from
the tap's number instead of the staged tables' broadcasts; ``no_quantize``
stores the sums' low bits instead of their rounded bytes; ``no_item_sync`` drops the barrier
between a tile's sums and its stores.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import torch

from imageprocessingtools_tpu_torch import profile_device
from imageprocessingtools_tpu_torch.kernels import _build
from imageprocessingtools_tpu_torch.utils import cache
from imageprocessingtools_tpu_torch.kernels import resize as k9

SOURCE = _build.CSRC / "resize.cu"
# name -> [(text in csrc/resize.cu, its replacement, how often the text occurs)]
CUTS = {
    "no_f64": [(
        "    return __dadd_rn(acc, __fma_rn(__hiloint2double(0x43300000, static_cast<int>(b)),"
        " w, nw));",
        "    return __hiloint2double(__double2hiint(acc) ^ b,"
        " __double2loint(acc) + b + __double2loint(w) + __double2loint(nw));", 1)],
    "no_conversion": [(
        "__fma_rn(__hiloint2double(0x43300000, static_cast<int>(b)), w, nw)",
        "__dmul_rn(__hiloint2double(0x43300000, static_cast<int>(b)), w)", 1)],
    "no_pixel_loads": [(
        "        for (int c = 0; c < C; ++c) acc[k][c] = tap(acc[k][c], p[c], wz, nwz);",
        "        for (int c = 0; c < C; ++c) acc[k][c] = tap(acc[k][c],"
        " static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p + c)) & 255, wz, nwz);", 1)],
    # dim 1's tiled sums' weights and addends from the tap's number, not
    # from the staged tables.
    "no_table_loads": [(
        "            const double2 w01 = *reinterpret_cast<const double2*>(wo + z);\n"
        "            const double2 w23 = *reinterpret_cast<const double2*>(wo + z + 2);\n"
        "            const double2 n01 = *reinterpret_cast<const double2*>(nwo + z);\n"
        "            const double2 n23 = *reinterpret_cast<const double2*>(nwo + z + 2);",
        "            const double2 w01 = make_double2(0.25 * z, 0.5), w23 = make_double2(0.75, z);"
        "\n            const double2 n01 = make_double2(-0.5 * z, 2.0), n23 = make_double2(3.0, -z);",
        1)],
    "no_stores": [
        ("            for (int j = lane; j < n_bytes / 4; j += 32) {",
         "            for (int j = lane; j < n_bytes / 4 - (1 << 30); j += 32) {", 1),
        ("            for (int j = lane; j < n_bytes; j += 32) q[j] = from[j];",
         "            for (int j = lane; j < n_bytes - (1 << 30); j += 32) q[j] = from[j];", 1),
        ("    uint8_t* q = dst + o * row_bytes + j;\n",
         "    uint8_t* q = dst + o * row_bytes + j;\n    if (acc[0] != 12345.678) return;\n", 1)],
    "no_row_staging": [
        ("            for (int j = lane; j < words; j += 32) __pipeline_memcpy_async(",
         "            for (int j = lane; j < words - (1 << 30); j += 32) __pipeline_memcpy_async(",
         1),
        ("        for (int j = lane; j < words; j += 32) {  // the image's first or last row",
         "        for (int j = lane; j < words - (1 << 30); j += 32) {  // the image's first or last"
         " row", 1)],
    "no_tap_loop": [
        ("        for (; z + 4 <= s.taps; z += 4) {",
         "        for (; z + 4 <= s.taps - (1 << 30); z += 4) {", 1),
        ("        for (; z < s.taps; ++z) tap_rows",
         "        for (; z < s.taps - (1 << 30); ++z) tap_rows", 1),
        ("        for (int z = 0; z < s.taps; ++z) {",
         "        for (int z = 0; z < s.taps - (1 << 30); ++z) {", 1),
        ("    for (int z = 0; z < taps; ++z) {",
         "    for (int z = 0; z < taps - (1 << 30); ++z) {", 1)],
    # The bytes' quantization: the sum's low bits instead.
    "no_quantize": [(
        "    const int v = __double2int_rd(__dadd_rn(acc, 0.5));",
        "    const int v = __double2loint(acc);", 1)],
    # The barrier between a tile's sums and its stores (dim 1).
    "no_item_sync": [(
        "        __syncthreads();  // the output tile is whole\n",
        "        // cut: the barrier before the stores\n", 1)],
    # Also ends the staging of rows: without its tables a group reaches no
    # column. Only with no_tap_loop: the tap loop would read indices that were
    # never staged.
    "no_tables": [(
        "    for (long long e = threadIdx.x; e < n; e += COLS_THREADS) {\n"
        "        const int v = __ldg(idx + e);",
        "    for (long long e = threadIdx.x; e < n - (1 << 30); e += COLS_THREADS) {\n"
        "        const int v = __ldg(idx + e);", 1)],
}
# (text, the text with a stamp beside it): in-kernel timestamps of dim 1's phases.
STAMP_NAMES = ["block start", "first tables staged, columns known", "tile 0's rows landed",
               "tile 1's rows landed", "tile 0 summed and stored", "block end"]
MAX_STAMPED_BLOCKS = 4096
STAMPS = [
    ("namespace {\n\nconstexpr int THREADS", """__device__ unsigned long long g_stamps[8 * 4096];
__device__ __forceinline__ void stamp(int k) {
    if (threadIdx.x == 0 && blockIdx.x < 4096) {
        unsigned long long t;
        asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
        g_stamps[blockIdx.x * 8 + k] = t;
    }
}
extern "C" int ipt_resize_stamps(void* out) {
    cudaError_t err = cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
    void* at = nullptr;
    if (err == cudaSuccess) err = cudaGetSymbolAddress(&at, g_stamps);
    if (err == cudaSuccess) err = cudaMemset(at, 0, sizeof(g_stamps));
    return static_cast<int>(err);
}
namespace {

constexpr int THREADS"""),
    ("    Cols s;\n    s.src = src;", "    stamp(0);\n    Cols s;\n    s.src = src;"),
    ("            if (span > 0) stage_tables<C>(s, g, s_lo, s_hi);\n",
     "            if (span > 0) stage_tables<C>(s, g, s_lo, s_hi);\n"
     "            if (i == begin) stamp(1);\n"),
    ("        __syncthreads();  // tile t has landed, the tables are staged, the last outputs "
     "stored\n",
     "        __syncthreads();  // tile t has landed, the tables are staged, the last outputs "
     "stored\n        if (i - begin < 2) stamp(2 + static_cast<int>(i - begin));\n"),
    ("        store_tile<C>(s, g, y0, static_cast<int>(min(static_cast<long long>(T), rows - y0)));"
     "\n    }\n}",
     "        store_tile<C>(s, g, y0, static_cast<int>(min(static_cast<long long>(T), rows - y0)));"
     "\n        if (i == begin) stamp(4);\n    }\n    stamp(5);\n}"),
]
DEFAULT = ["base", *(name for name in CUTS if name != "no_tables"),
           "no_f64,no_pixel_loads", "no_f64,no_pixel_loads,no_table_loads",
           "no_f64,no_pixel_loads,no_stores,no_row_staging", "no_tap_loop,no_tables",
           "no_tap_loop,no_tables,no_stores", "stamps"]
# label -> (shape, new width)
# The "x 10" cases are ten 4K images' rows as one image: the W pass of a group
# of ten (its rows are one image's), with another H pass.
CASES = {"4K -> 1920 RGB": ((2160, 3840, 3), 1920), "4K -> 256 RGB": ((2160, 3840, 3), 256),
         "4K -> 1920 gray": ((2160, 3840), 1920), "1080p -> 3840 RGB": ((1080, 1920, 3), 3840),
         "4K x 10 -> 1920 RGB": ((21600, 3840, 3), 1920),
         "4K x 10 -> 256 RGB": ((21600, 3840, 3), 256)}
LAUNCHES, REPEATS = 30, 5


def cut_source(text: str, cuts: list[str]) -> str:
    """``text`` (``csrc/resize.cu``) with ``cuts`` applied; raises if a cut's
    text does not occur as often as it should (the source has moved on)."""
    if "no_tables" in cuts and "no_tap_loop" not in cuts:
        raise SystemExit("resize_cuts: no_tables needs no_tap_loop (the loop would read indices "
                         "that were never staged)")
    for name in cuts:
        if name == "base":
            continue
        if name == "stamps":
            for old, new in STAMPS:
                if text.count(old) != 1:
                    raise RuntimeError(f"resize_cuts: stamps: its text occurs {text.count(old)} "
                                       f"times in {SOURCE.name}, not once: {old!r}")
                text = text.replace(old, new)
            continue
        if name not in CUTS:
            raise SystemExit(f"resize_cuts: unknown cut {name!r}; known: base, stamps, "
                             f"{', '.join(CUTS)}")
        for old, new, count in CUTS[name]:
            if text.count(old) != count:
                raise RuntimeError(f"resize_cuts: cut {name!r}: its text occurs {text.count(old)} "
                                   f"times in {SOURCE.name}, not {count}: {old!r}")
            text = text.replace(old, new)
    return text


def build(cuts: list[str]) -> ctypes.CDLL:
    out_dir = cache.build_dir() / "resize_cuts"
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = "_".join(cuts)
    source = out_dir / f"resize_{stem}.cu"
    source.write_text(cut_source(SOURCE.read_text(), cuts))
    out = out_dir / f"libipt_resize_{stem}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o", str(out),
           str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.ipt_resize_pass.argtypes = _build._SIGNATURES["ipt_resize_pass"]
    lib.ipt_resize_pass.restype = ctypes.c_int
    return lib


def time_cut(lib: ctypes.CDLL, images: dict, dev, check: bool) -> dict:
    row = {}
    for label, (shape, new_width) in CASES.items():
        src = images[label]
        for dim, idx, w in k9.device_passes(shape[0], shape[1], new_width, dev):
            exp = k9.resize_pass(src, idx, w, dim)  # the library's kernel: the next pass's input
            dst = torch.empty_like(exp)
            args = k9.launch_args(src, dst, idx, w, dim)

            def launch():
                status = lib.ipt_resize_pass(*args)
                if status:
                    raise RuntimeError(f"{label} dim {dim}: CUDA error {status} at launch")

            launch()
            torch.cuda.synchronize()
            if check and not torch.equal(dst, k9.resize_pass_plain(src, idx, w, dim)):
                raise RuntimeError(f"base: {label} dim {dim} differs from the plain version")
            samples = []
            for _ in range(REPEATS):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(LAUNCHES):
                    launch()
                end.record()
                end.synchronize()
                samples.append(start.elapsed_time(end) / LAUNCHES)
            row[f"{label}, dim {dim}, {idx.shape[1]} taps, ms"] = statistics.median(samples)
            src = exp
    return row


def read_stamps(lib: ctypes.CDLL, images: dict, dev) -> dict:
    """Each case's W pass once with the stamped kernel: per stamp its least,
    median and largest time over the blocks, us from the first block's start."""
    import numpy as np

    lib.ipt_resize_stamps.argtypes = [ctypes.c_void_p]
    lib.ipt_resize_stamps.restype = ctypes.c_int
    buf = np.zeros(8 * MAX_STAMPED_BLOCKS, dtype=np.uint64)
    rows = {}
    for label, (shape, new_width) in CASES.items():
        src = images[label]
        dim, idx, w = k9.device_passes(shape[0], shape[1], new_width, dev)[0]
        if dim != 1:
            raise RuntimeError(f"{label}: the first pass is not the W pass")
        dst = torch.empty_like(k9.resize_pass(src, idx, w, dim))
        args = k9.launch_args(src, dst, idx, w, dim)
        for _ in range(3):  # the third launch's stamps are read
            torch.cuda.synchronize()
            if lib.ipt_resize_stamps(buf.ctypes.data):
                raise RuntimeError("reading the stamps failed")
            if lib.ipt_resize_pass(*args):
                raise RuntimeError(f"{label}: CUDA error at launch")
        torch.cuda.synchronize()
        if lib.ipt_resize_stamps(buf.ctypes.data):
            raise RuntimeError("reading the stamps failed")
        stamps = buf.reshape(MAX_STAMPED_BLOCKS, 8).astype(np.int64)
        stamps = stamps[stamps[:, 0] > 0][:, :len(STAMP_NAMES)]
        # a block whose strip is one step long never stamps step 1
        since = np.where(stamps > 0, (stamps - stamps[:, 0].min()) / 1e3, np.nan)
        rows[label] = {"blocks": int(len(stamps)), **{
            name: [float(np.nanmin(since[:, k])), float(np.nanmedian(since[:, k])),
                   float(np.nanmax(since[:, k]))] for k, name in enumerate(STAMP_NAMES)}}
    return rows


def main(argv=None) -> int:
    from imageprocessingtools_tpu_torch import device

    if not torch.cuda.is_available():
        raise SystemExit("resize_cuts: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = device.get_device()
    dev = torch.device(dev.type, torch.cuda.current_device())
    images = {label: torch.from_numpy(profile_device._image(shape, seed=1)).to(dev)
              for label, (shape, _) in CASES.items()}
    for spec in (sys.argv[1:] if argv is None else argv) or DEFAULT:
        cuts = spec.split(",")
        if cuts == ["stamps"]:
            print(json.dumps({"stamps_us_min_median_max": read_stamps(build(cuts), images, dev)}),
                  flush=True)
            continue
        row = time_cut(build(cuts), images, dev, check=cuts == ["base"])
        print(json.dumps({"cuts": spec, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
