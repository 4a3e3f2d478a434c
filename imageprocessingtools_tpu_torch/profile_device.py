"""Profile the port on one CUDA card: device time per kernel, the serving split.

Run from the root of the repository, with one CUDA card:

    python -m imageprocessingtools_tpu_torch.profile_device [WORD ...]

With words, only the kernel cases whose label holds one of them are profiled
(``K9``, ``rotate``), and the serving runs only if ``serving`` is among them.
It prints the card's name and power limit, then one JSON object per line:

- ``{"kernel": label, ...}``: each kernel wrapper (and the two kernel forms
  of the flagship, and edge_detect's K6 + Sobel) called 20 times back to
  back on 2160x3840 inputs on the card under ``torch.profiler``; the device
  time per call is the sum of the trace's device events (kernels, memcpys,
  memsets) over the 20 calls, divided by 20, also split by event name. The inputs are those of
  ``chip_smoke.py`` phase 3: noise from seed 1, its gray (made by the plain
  ``core.grayscale_plain``, so that no kernel makes another's input),
  constant images, and for K2 and K4 a diagonal gradient over 0..255. K8 is
  profiled with the empty chain (``grayscale``) and
  with the full chain (invert, brightness 30, contrast 1.5, threshold 128).
  K1 is also profiled at 45 and 135 degrees, and K9 (two launches per resize,
  listed by kernel name) through ``resize_width`` at 4K -> 1920, 4K -> 256
  (the ``thumbnail`` preset), 1080p -> 3840 and 4K gray -> 1920, beside the
  dense float32 form ``resize_width_dense`` at 4K -> 1920; the fused
  pipeline, edge_detect, K1 at 30 degrees and K9 at 4K -> 1920 in four row
  bands on the card (``parallel/spatial.py``, input on the card, cases
  "spatial ..."). Back-to-back calls on one 4K
  input find it in the 50 MB L2 cache, so K1, K2, K6 and K8 are also profiled
  over four noise inputs in turn (seeds 1-4, 100 MB), and K4, K5 and K7's
  three instances over their four grays in turn (33 MB; with K5's and K7's
  four outputs another 33 MB), where each call's input is cold or nearly so.
  Each line carries ``events``, the number of device events in its trace:
  a case is printed only if every event name occurs 20 times as often as in
  one profiled single call; a trace that lost events is taken again, and
  after five attempts the run stops with a non-zero exit code and names
  the case.
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
import itertools
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
FULL_CHAIN = (("invert", 0), ("brightness", 30), ("contrast", 1.5), ("threshold", 128))
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


def lost_events(events: list[dict], per_call: dict[str, int], reps: int) -> dict[str, list[int]]:
    """``{name: [found, wanted]}`` for every event name whose count in
    ``events``, the trace of ``reps`` calls, is not ``reps`` times its count
    in one call (``per_call``). Empty when the trace is complete."""
    found = collections.Counter(e["name"] for e in events)
    return {name: [found[name], reps * per_call.get(name, 0)]
            for name in sorted(set(found) | set(per_call))
            if found[name] != reps * per_call.get(name, 0)}


ATTEMPTS = 5


def _profiled(fn, attempts: int = ATTEMPTS):
    """The device events of one profiled call of ``fn``. After many
    profiles in one process the tracer has returned a trace without device
    events, also several times in a row; such a profile is taken again after
    a pause, up to ``attempts`` times."""
    for attempt in range(attempts):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        try:
            return device_events(prof)
        except RuntimeError:
            if attempt == attempts - 1:
                raise
            time.sleep(0.5)


def _image(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def profile_kernels(dev, words=()) -> None:
    from imageprocessingtools_tpu_torch.kernels import core, fused, rotate
    from imageprocessingtools_tpu_torch.ops.histogram import _equalize_lut
    from imageprocessingtools_tpu_torch.ops.resize import resize_width, resize_width_dense
    from imageprocessingtools_tpu_torch.parallel import spatial

    mesh4 = (dev,) * 4  # four row bands on the one card

    img = torch.from_numpy(_image((H4K, W4K, 3), seed=1)).to(dev)
    img_1080 = torch.from_numpy(_image((1080, 1920, 3), seed=5)).to(dev)
    inputs = [img] + [torch.from_numpy(_image((H4K, W4K, 3), seed=s)).to(dev) for s in (2, 3, 4)]
    in_turn = itertools.cycle(inputs)
    grays_in_turn = itertools.cycle([core.grayscale_plain(x) for x in inputs])
    const_rgb = torch.full((H4K, W4K, 3), 201, dtype=torch.uint8, device=dev)
    gray, const = core.grayscale_plain(img), const_rgb[:, :, 0].contiguous()
    ys, xs = torch.arange(H4K, device=dev)[:, None], torch.arange(W4K, device=dev)[None, :]
    gradient = ((ys + xs) * 255 // (H4K + W4K - 2)).to(torch.uint8)[:, :, None].expand(
        H4K, W4K, 3).contiguous()
    gradient_gray = gradient[:, :, 0].contiguous()
    lut = _equalize_lut(core.histogram(gray), H4K * W4K)
    cases = {
        "K1 rotate 30, RGB": lambda: rotate.rotate_bicubic(img, 30.0),
        "K1 rotate 45, RGB": lambda: rotate.rotate_bicubic(img, 45.0),
        "K1 rotate 135, RGB": lambda: rotate.rotate_bicubic(img, 135.0),
        "K1 rotate 30, RGB, 4 inputs in turn": lambda: rotate.rotate_bicubic(next(in_turn), 30.0),
        "K2 gray_gauss_hist, noise": lambda: core.gray_gauss_hist(img),
        "K2 gray_gauss_hist, constant": lambda: core.gray_gauss_hist(const_rgb),
        "K2 gray_gauss_hist, gradient": lambda: core.gray_gauss_hist(gradient),
        "K2 gray_gauss_hist, 4 inputs in turn": lambda: core.gray_gauss_hist(next(in_turn)),
        "K3 lut_apply": lambda: core.lut_apply(gray, lut),
        "K4 histogram, noise": lambda: core.histogram(gray),
        "K4 histogram, constant": lambda: core.histogram(const),
        "K4 histogram, gradient": lambda: core.histogram(gradient_gray),
        "K4 histogram, 4 inputs in turn": lambda: core.histogram(next(grays_in_turn)),
        "K5 gaussian_blur": lambda: core.gaussian_blur(gray),
        "K5 gaussian_blur, 4 inputs in turn": lambda: core.gaussian_blur(next(grays_in_turn)),
        "K6 gray_gauss": lambda: core.gray_gauss(img),
        "K7 box_blur": lambda: core.box_blur(gray),
        "K7 sharpen": lambda: core.sharpen(gray),
        "K7 sobel": lambda: core.sobel(gray),
        "K8 fused_elementwise, empty chain": lambda: core.fused_elementwise(img),
        "K8 fused_elementwise, full chain": lambda: core.fused_elementwise(img, FULL_CHAIN),
        "K6 gray_gauss, 4 inputs in turn": lambda: core.gray_gauss(next(in_turn)),
        "K8 fused_elementwise, empty chain, 4 inputs in turn":
            lambda: core.fused_elementwise(next(in_turn)),
        "K7 box_blur, 4 inputs in turn": lambda: core.box_blur(next(grays_in_turn)),
        "K7 sharpen, 4 inputs in turn": lambda: core.sharpen(next(grays_in_turn)),
        "K7 sobel, 4 inputs in turn": lambda: core.sobel(next(grays_in_turn)),
        "flagship mega": lambda: fused.fused_pipeline_mega(img),
        "flagship staged": lambda: fused.fused_pipeline_staged(img),
        "edge_detect": lambda: core.sobel(core.gray_gauss(img)),
        "K9 resize_width 4K -> 1920, RGB": lambda: resize_width(img, 1920),
        "K9 resize_width 4K -> 1920, RGB, 4 inputs in turn":
            lambda: resize_width(next(in_turn), 1920),
        "K9 resize_width 4K -> 256, RGB": lambda: resize_width(img, 256),
        "K9 resize_width 1080p -> 3840, RGB": lambda: resize_width(img_1080, 3840),
        "K9 resize_width 4K -> 1920, gray": lambda: resize_width(gray, 1920),
        "dense resize_width_dense 4K -> 1920, RGB": lambda: resize_width_dense(img, 1920),
        "spatial fused, 4 bands": lambda: spatial.fused_pipeline_spatial(img, mesh4),
        "spatial edge_detect, 4 bands":
            lambda: spatial.preset_pipeline_spatial(img, "edge_detect", mesh4),
        "spatial K1 rotate 30, RGB, 4 bands": lambda: spatial.rotate_spatial(img, 30.0, mesh4),
        "spatial K9 resize_width 4K -> 1920, RGB, 4 bands":
            lambda: spatial.resize_width_spatial(img, 1920, mesh4),
    }
    for label, fn in cases.items():
        if words and not any(word in label for word in words):
            continue
        fn()  # warm-up: the build, the first launch
        torch.cuda.synchronize()
        events = _complete_trace(label, fn)
        by_name = collections.Counter()
        for e in events:
            by_name[e["name"][:80]] += e["dur"] / REPS
        print(json.dumps({"kernel": label, "device_us_per_call": sum(by_name.values()),
                          "events": len(events),
                          "by_name": dict(by_name.most_common())}), flush=True)


def _complete_trace(label: str, fn) -> list[dict]:
    """The device events of ``REPS`` profiled calls of ``fn``, checked
    against one profiled single call: every event name must occur ``REPS``
    times as often. A trace that lost events (or a single call that did) is
    taken again, up to ``ATTEMPTS`` times; then the run stops, so that no
    time is ever printed from a short trace."""
    for _ in range(ATTEMPTS):
        per_call = collections.Counter(e["name"] for e in _profiled(fn))
        events = _profiled(lambda: [fn() for _ in range(REPS)])
        lost = lost_events(events, per_call, REPS)
        if not lost:
            return events
    raise SystemExit(f"profile_device: case {label!r}: the trace of {REPS} calls does not hold "
                     f"{REPS} x one call's events after {ATTEMPTS} attempts "
                     f"(name: [found, wanted]): {json.dumps(lost)}")


def device_us_per_call(label: str, fn) -> float:
    """Device us per call of ``fn``: the device events of ``REPS`` profiled
    calls (a complete trace, ``_complete_trace``) summed, over ``REPS``."""
    fn()
    torch.cuda.synchronize()
    return sum(e["dur"] for e in _complete_trace(label, fn)) / REPS


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


def main(argv=None) -> int:
    from imageprocessingtools_tpu_torch import device

    words = tuple(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_device: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = device.get_device()
    profile_kernels(dev, words)
    if not words or "serving" in words:
        with tempfile.TemporaryDirectory() as tmp:
            profile_serving(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
