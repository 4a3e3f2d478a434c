"""Profile the port on one CUDA card: device time per kernel, the serving split.

Run from the root of the repository, with one CUDA card:

    python -m imageprocessingtools_tpu_torch.profile_device

It prints the card's name and power limit, then one JSON object per line:

- ``{"kernel": label, ...}``: each kernel wrapper (and the two kernel forms
  of the flagship) called 20 times back to back on 2160x3840 inputs on the
  card under ``torch.profiler``; the device time per call is the sum of the
  trace's device events (kernels, memcpys, memsets) over the 20 calls,
  divided by 20, also split by event name. The inputs are those of
  ``chip_smoke.py`` phase 3: noise from seed 1, its gray, and constant
  images.
- ``{"serving": "split", ...}``: ``serving.process_files`` with the four
  presets over 8 4K and 2 1080p P6 files (seeds 40-49, as in
  ``chip_smoke.py`` phase 6), sequential (no reader or writer thread),
  after one warm-up run; host seconds in ``_read_and_decode`` (read and
  decode), ``process_batch`` (upload and device, synchronised), ``_to_host``
  (download) and ``_encode_chunk`` (encode and write).
- ``{"serving": "overlapped" | "max_batch 2", ...}``: the same run with the
  threads under ``torch.profiler``; the device's busy share is the union of
  its events' intervals over the host wall of the run, with the totals of
  host-to-device and device-to-host copies and of the kernels.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPS = 20
H4K, W4K = 2160, 3840
PRESETS = ("edge_detect", "enhance", "print_ready", "thumbnail")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(prof) -> list[dict]:
    """The device events (kernels, copies, memsets) of a finished profile,
    read from its Chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    found = [e for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    if not found:
        raise RuntimeError("the profiler recorded no device event")
    return found


def busy_us(events: list[dict]) -> float:
    """Length of the union of the events' [ts, ts + dur) intervals, in us."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_events(prof)


def _image(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def profile_kernels(dev) -> None:
    from imageprocessingtools_tpu_torch.kernels import core, fused, rotate
    from imageprocessingtools_tpu_torch.ops.color import grayscale
    from imageprocessingtools_tpu_torch.ops.histogram import _equalize_lut

    img = torch.from_numpy(_image((H4K, W4K, 3), seed=1)).to(dev)
    const_rgb = torch.full((H4K, W4K, 3), 201, dtype=torch.uint8, device=dev)
    gray, const = grayscale(img), const_rgb[:, :, 0].contiguous()
    lut = _equalize_lut(core.histogram(gray), H4K * W4K)
    cases = {
        "K1 rotate 30, RGB": lambda: rotate.rotate_bicubic(img, 30.0),
        "K2 gray_gauss_hist, noise": lambda: core.gray_gauss_hist(img),
        "K2 gray_gauss_hist, constant": lambda: core.gray_gauss_hist(const_rgb),
        "K3 lut_apply": lambda: core.lut_apply(gray, lut),
        "K4 histogram, noise": lambda: core.histogram(gray),
        "K4 histogram, constant": lambda: core.histogram(const),
        "K5 gaussian_blur": lambda: core.gaussian_blur(gray),
        "K7 box_blur": lambda: core.box_blur(gray),
        "K7 sharpen": lambda: core.sharpen(gray),
        "K7 sobel": lambda: core.sobel(gray),
        "flagship mega": lambda: fused.fused_pipeline_mega(img),
        "flagship staged": lambda: fused.fused_pipeline_staged(img),
    }
    for label, fn in cases.items():
        fn()  # warm-up: the build, the first launch
        torch.cuda.synchronize()
        events = _profiled(lambda: [fn() for _ in range(REPS)])
        by_name = collections.Counter()
        for e in events:
            by_name[e["name"][:80]] += e["dur"] / REPS
        print(json.dumps({"kernel": label, "device_us_per_call": sum(by_name.values()),
                          "by_name": dict(by_name.most_common())}), flush=True)


def profile_serving(tmp: str) -> None:
    from imageprocessingtools_tpu_torch import serving
    from imageprocessingtools_tpu_torch.codec import ppm

    files = []
    for i, (h, w) in enumerate([(H4K, W4K)] * 8 + [(1080, 1920)] * 2):
        files.append(os.path.join(tmp, f"f{i}.ppm"))
        ppm.write_ppm(files[-1], _image((h, w, 3), seed=40 + i))

    def run(**kw) -> float:
        t0 = time.perf_counter()
        serving.process_files(files, PRESETS, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    first = run(overlap=False)
    split = collections.Counter()
    stages = {"_read_and_decode": "decode", "process_batch": "upload_and_device",
              "_to_host": "download", "_encode_chunk": "encode"}
    originals = {name: getattr(serving, name) for name in stages}

    def timed(name):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = originals[name](*args, **kwargs)
            torch.cuda.synchronize()
            split[stages[name]] += time.perf_counter() - t0
            return out
        return wrapper

    for name in stages:
        setattr(serving, name, timed(name))
    try:
        wall = run(overlap=False)
    finally:
        for name, fn in originals.items():
            setattr(serving, name, fn)
    print(json.dumps({"serving": "split", "files": len(files), "wall_s": wall,
                      "first_run_s": first, **{f"{k}_s": v for k, v in split.items()}}),
          flush=True)

    for label, kw in (("overlapped", {}), ("max_batch 2", {"max_batch": 2})):
        run(**kw)
        walls = []
        events = _profiled(lambda: walls.append(run(**kw)))
        copies = collections.Counter()
        for e in events:
            kind = ("htod" if "HtoD" in e["name"] else "dtoh" if "DtoH" in e["name"]
                    else "other_copy") if e["cat"] == "gpu_memcpy" else e["cat"]
            copies[kind] += e["dur"] / 1e3
        busy = busy_us(events) / 1e6
        print(json.dumps({"serving": label, "files": len(files), "wall_s": walls[0],
                          "device_busy_s": busy, "device_busy_share": busy / walls[0],
                          **{f"{k}_ms": v for k, v in copies.items()}}), flush=True)


def main() -> int:
    from imageprocessingtools_tpu_torch import device

    if not torch.cuda.is_available():
        raise SystemExit("profile_device: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = device.get_device()
    profile_kernels(dev)
    with tempfile.TemporaryDirectory() as tmp:
        profile_serving(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
