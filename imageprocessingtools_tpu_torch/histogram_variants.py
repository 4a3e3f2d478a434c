"""Time K4's design space on one CUDA card: the counting layouts, flushes,
block sizes and grids of ``csrc/variants/histogram_variants.cu``.

Run from the root of the repository, with one CUDA card:

    python -m imageprocessingtools_tpu_torch.histogram_variants

It builds the variants' source with nvcc (the kernel library's flags) into
its own shared library, prints the card's name and power limit, and then one
JSON object per variant: its grid, and its device time per call in us on a
2160x3840 noise gray (``profile_device``'s: the plain gray of seed 1), a
constant image, a diagonal gradient, and four noise grays in turn (cold in
L2). A device time is the sum of the trace's device events over 20 calls
under ``torch.profiler``, divided by 20, from a trace that holds each of
the call's device operations 20 times; it includes the ``torch.zeros`` fill of
the variants whose flush needs a zeroed output. Every variant but the two
cuts must give ``torch.bincount``'s counts on every input. The last line is
the kept kernel, ``core.histogram``, timed the same way in the same process.
"""

from __future__ import annotations

import collections
import ctypes
import itertools
import json
import subprocess
import sys

import torch

from imageprocessingtools_tpu_torch import profile_device
from imageprocessingtools_tpu_torch.kernels import _build
from imageprocessingtools_tpu_torch.utils import cache

SOURCE = _build.CSRC / "variants" / "histogram_variants.cu"
H4K, W4K = profile_device.H4K, profile_device.W4K
# id -> (label, the flush needs a zeroed output, the counts are right)
VARIANTS = {
    0: ("first design: block int[256] atomics, global-atomic flush, <= 1024 x 256", True, True),
    1: ("cut: first design without its flush", True, False),
    2: ("cut: first design with plain stores in place of the shared atomics", True, False),
    3: ("first design + runs of 16 equal bytes", True, True),
    4: ("resident 1024-thread blocks, block atomics, runs", True, True),
    5: ("resident 256-thread blocks, block atomics, runs", True, True),
    6: ("resident 1024, per-warp 16-bit sub-histograms, runs", True, True),
    7: ("resident 256, per-warp 16-bit sub-histograms, runs", True, True),
    8: ("resident 1024, lane-strided int32, runs", True, True),
    9: ("resident 512, lane-strided int32, runs", True, True),
    10: ("resident 256, lane-strided int32, runs", True, True),
    11: ("resident 1024, lane-strided 16-bit, runs", True, True),
    12: ("resident 512, lane-strided 16-bit, runs", True, True),
    13: ("resident 256, lane-strided 16-bit, runs", True, True),
    14: ("resident 1024, lane-strided int32, runs, rows + ticket", False, True),
    15: ("resident 1024, lane-strided int32, runs, accumulator + ticket", False, True),
    16: ("resident 1024, lane-strided 16-bit, runs, rows + ticket", False, True),
    17: ("resident 1024, lane-strided 16-bit, runs, accumulator + ticket", False, True),
    18: ("resident 512, lane-strided 16-bit, runs, accumulator + ticket", False, True),
    19: ("resident 512, lane-strided int32, runs, accumulator + ticket", False, True),
    20: ("resident 1024, lane-strided 16-bit, no runs, accumulator + ticket", False, True),
    21: ("resident 1024, block atomics, runs, accumulator + ticket", False, True),
    22: ("cut: resident 1024, block atomics, runs, no flush", True, False),
    23: ("cut: resident 1024, lane-strided int32, runs, no flush", True, False),
    24: ("resident 1024, block atomics, runs, packed 64-bit arrivals", False, True),
    25: ("resident 1024, lane-strided int32, runs, packed 64-bit arrivals", False, True),
    26: ("1 x 1024 per SM, block atomics, runs", True, True),
    27: ("1 x 1024 per SM, block atomics, runs, packed 64-bit arrivals", False, True),
    28: ("1 x 1024 per SM, lane-strided int32, runs", True, True),
    29: ("1 x 1024 per SM, lane-strided int32, runs, packed 64-bit arrivals", False, True),
    30: ("2 x 512 per SM, block atomics, runs, packed 64-bit arrivals", False, True),
    31: ("1 x 512 per SM, block atomics, runs, packed 64-bit arrivals", False, True),
    32: ("1 x 512 per SM, lane-strided int32, runs, packed 64-bit arrivals", False, True),
    33: ("2 x 512 per SM, lane-strided int32, runs, packed 64-bit arrivals", False, True),
    34: ("1 x 768 per SM, lane-strided int32, runs, packed 64-bit arrivals", False, True),
    35: ("1 x 1024 per SM, lane-strided int32, runs of 16 and of 4, packed 64-bit arrivals",
         False, True),
    36: ("1 x 1024 per SM, block atomics, runs of 16 and of 4, packed 64-bit arrivals",
         False, True),
    100: ("1 x 1024 per SM, lane-strided int32, runs, 4 loads in flight, loads before the zeroing, "
          "packed 64-bit arrivals in one level", False, True),
    101: ("cut: 100 without its flush", False, False),
    102: ("cut: 100 without its flush and without counting (loads only)", False, False),
    103: ("100 with the global-atomic flush into a zeroed output", True, True),
    104: ("100, four threads fold a bin", False, True),
    105: ("100, 2 loads in flight", False, True),
    106: ("100, 1 x 512 per SM, 8 loads in flight", False, True),
    107: ("100, 1 x 512 per SM, two threads fold a bin", False, True),
    108: ("100, one block per 2 SMs, 8 loads in flight", False, True),
    109: ("cut: one block per 2 SMs without its flush", False, False),
    110: ("100, 1 x 768 per SM", False, True),
    111: ("2 loads in flight, two-level flush in 4 groups", False, True),
    112: ("2 loads in flight, two-level flush in 12 groups", False, True),
    113: ("2 loads in flight, two-level flush in 33 groups", False, True),
    114: ("1 load in flight", False, True),
    115: ("1 load in flight, two-level flush in 12 groups: the kept design", False, True),
    116: ("1 x 512 per SM, 2 loads in flight, two-level flush in 12 groups", False, True),
    117: ("1 x 512 per SM, 4 loads in flight, two-level flush in 12 groups", False, True),
    118: ("cut: 2 loads in flight without its flush", False, False),
    119: ("2 loads in flight, four threads fold a bin, two-level flush in 12 groups", False, True),
    120: ("1 load in flight, two-level flush in 8 groups", False, True),
    121: ("1 load in flight, two-level flush in 16 groups", False, True),
    122: ("1 x 512 per SM, 1 load in flight, two-level flush in 12 groups", False, True),
    123: ("1 load in flight, four threads fold a bin, two-level flush in 12 groups", False, True),
    124: ("cut: the kept design without its flush", False, False),
    125: ("1 x 768 per SM, 1 load in flight, two-level flush in 12 groups", False, True),
}


def build() -> ctypes.CDLL:
    out = cache.build_dir() / "libipt_histogram_variants.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    p = ctypes.c_void_p
    lib.ipt_histogram_variant.argtypes = [ctypes.c_int, p, p, p, ctypes.c_longlong, ctypes.c_int,
                                          p, ctypes.POINTER(ctypes.c_int)]
    lib.ipt_histogram_variant.restype = ctypes.c_int
    return lib


def device_us(label: str, fn, operations: int = 1) -> float:
    """Device us per call of ``fn``, which runs ``operations`` device
    operations (the kernel, and the fill where the output is zeroed), from a
    trace of 20 calls that holds each of them 20 times."""
    reps = profile_device.REPS
    fn()
    torch.cuda.synchronize()
    for _ in range(profile_device.ATTEMPTS):
        events = profile_device._profiled(lambda: [fn() for _ in range(reps)])
        names = collections.Counter(e["name"] for e in events)
        if len(names) == operations and set(names.values()) == {reps}:
            return sum(e["dur"] for e in events) / reps
    raise SystemExit(f"histogram_variants: {label}: the trace of {reps} calls holds {dict(names)}, "
                     f"not {operations} operations {reps} times each")


def main() -> int:
    from imageprocessingtools_tpu_torch import device
    from imageprocessingtools_tpu_torch.kernels import core

    if not torch.cuda.is_available():
        raise SystemExit("histogram_variants: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = device.get_device()
    lib = build()
    grays = [core.grayscale_plain(torch.from_numpy(profile_device._image((H4K, W4K, 3), seed=s))
                                  .to(dev)) for s in (1, 2, 3, 4)]
    ys, xs = torch.arange(H4K, device=dev)[:, None], torch.arange(W4K, device=dev)[None, :]
    inputs = {
        "noise": grays[0],
        "constant": torch.full((H4K, W4K), 201, dtype=torch.uint8, device=dev),
        "gradient": ((ys + xs) * 255 // (H4K + W4K - 2)).to(torch.uint8),
    }
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = torch.zeros(512 + 256 * 4096, dtype=torch.int32, device=dev)  # also 64-bit words
    blocks = ctypes.c_int(0)

    for variant, (label, zeroed, right) in VARIANTS.items():
        def call(values):
            hist = (torch.zeros if zeroed else torch.empty)(256, dtype=torch.int32, device=dev)
            status = lib.ipt_histogram_variant(variant, values.data_ptr(), hist.data_ptr(),
                                               scratch.data_ptr(), values.numel(),
                                               values.device.index, stream, ctypes.byref(blocks))
            if status:
                raise RuntimeError(f"variant {variant}: CUDA error {status} at launch")
            return hist

        scratch.zero_()  # the rows of an earlier variant are not zero
        row = {"variant": variant, "label": label}
        for what, values in inputs.items():
            if right and not torch.equal(call(values), core.histogram_plain(values)):
                raise RuntimeError(f"variant {variant} ({label}) miscounts the {what} input")
            row[f"{what}_us"] = device_us(f"{label}, {what}", lambda: call(values), 1 + zeroed)
        in_turn = itertools.cycle(grays)
        row["noise_4_in_turn_us"] = device_us(f"{label}, 4 in turn",
                                              lambda: call(next(in_turn)), 1 + zeroed)
        row["blocks"] = blocks.value
        print(json.dumps(row), flush=True)

    row = {"variant": "kept", "label": "core.histogram (csrc/histogram.cu)"}
    for what, values in inputs.items():
        row[f"{what}_us"] = device_us(f"kept, {what}", lambda: core.histogram(values))
    in_turn = itertools.cycle(grays)
    row["noise_4_in_turn_us"] = device_us("kept, 4 in turn", lambda: core.histogram(next(in_turn)))
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
