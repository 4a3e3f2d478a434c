#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card, and check them.

Run from the root of the repository, with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``imageprocessingtools_tpu_torch/csrc``
(nvcc, sm_90a, one process per source) and runs, in order, printing one line
per phase:

1. the device: torch and CUDA versions, the card's name and power limit;
2. the kernel build, with its seconds;
3. each kernel against its plain torch version on the same CUDA tensors at
   the main paths' shapes and at odd ones (byte-equal required), with each
   one's ms per call at 4K (CUDA events around 20 back-to-back calls, median
   of 5 such runs), its least time on the card from the bytes and operations
   of that 4K call, and the time of the one PyTorch call that computes the
   same function, where there is one (K9, the resize pass, is checked and
   timed through ``resize_width`` and ``resize``, two launches each);
4. the CLI (``imageprocessingtools_tpu_torch.cli.main``) over four 4K P6
   files, each run split into decode, resize plan and table upload, upload
   and device, download, and encode and write (``-w1920`` twice: its first
   call makes and uploads the tables, its second finds them on the card),
   with a byte-for-byte cross-check of a smaller file against the same CLI
   run on the CPU in a subprocess (``IPT_DEVICE=cpu``);
5. the flagship fused pipeline at 4K through K2 and K3, and its staged form
   through K8, K5, K4 and K3, each byte-equal to the plain torch pipeline;
   then a batch of four 4K images through ``parallel.batched_fused_pipeline``
   (K2 and K3 once per image), byte-equal to the plain pipeline per image;
6. preset serving (``imageprocessingtools_tpu_torch.serve.main``): the four
   presets fanned out over eight 4K and two 1080p P6 files and one truncated
   file (``--skip-bad``), every output byte-equal to the presets' plain
   bodies on the same decoded image on the card; a reference-flag fan-out
   over the 4K files; and a byte-for-byte cross-check of a smaller file
   against the same ``serve`` run on the CPU in a subprocess;
7. spatial and mesh (``parallel/spatial.py``): on a 4K noise image, with a
   mesh that names the card four times (four row bands), the fused pipeline,
   the four presets, ``-w1920 -r30 -mono -fv`` and ``-r90``, each byte-equal
   to the unsharded path on the card and to the plain path on the CPU (K1
   runs in its band form there); the band and unsharded forms of the fused
   pipeline and of edge_detect timed side by side (ms per call, and device
   us from a ``torch.profiler`` trace); then ``serve --mesh`` and ``serve
   --spatial`` over phase 6's files, byte-equal to phase 6's outputs. Where
   torch sees more than one card, the spatial paths and a batch also run
   over a mesh of every card (copies between cards); otherwise the line
   says that they were not exercised.

Every kernel's launch count is set to 0 just before each of phases 4, 5 (the
flagship, then the batch), 6 and 7 (the band paths, then the moved serving)
and read just after it; a kernel that a phase's path uses and that was not
launched there is a failure. The line before the last is a JSON object with
each kernel's launches (summed over the four paths), error, times, least
time and the PyTorch call's time; the last line is
``{"ok": true, "device": {...}}``. Any failure raises, and the
script then exits non-zero without printing either line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
H4K, W4K = 2160, 3840
REPS = 20
PKG = "imageprocessingtools_tpu_torch"
PALLAS = "imageprocessingtools_tpu/kernels/pallas_core.py"
# name -> (source, the Pallas function it replaces)
KERNELS = {
    "rotate": ("rotate.cu", "imageprocessingtools_tpu/kernels/pallas_rotate.py:581"),
    "gray_gauss_hist": ("gray_gauss_hist.cu", f"{PALLAS}:677"),
    "lut_apply": ("lut_apply.cu", f"{PALLAS}:464"),
    "histogram": ("histogram.cu", f"{PALLAS}:392"),
    "gaussian_blur": ("stencil.cu", f"{PALLAS}:120"),
    "gray_gauss": ("gray_gauss_hist.cu", f"{PALLAS}:547"),
    "stencil3": ("stencil.cu", f"{PALLAS}:161"),
    "fused_elementwise": ("elementwise.cu", f"{PALLAS}:228"),
    # K9 has no Pallas counterpart: it replaces the JAX package's dense
    # matrix pass (and its host loop for the exact mode).
    "resize_pass": ("resize.cu", "imageprocessingtools_tpu/ops/resize.py:59"),
}
# K7's instances: the template's three wrappers. Box is on no path (no preset
# uses it), nor is K8 with a non-empty chain (the paths run it with the
# empty chain, as grayscale); phase 3 holds both to their plain versions.
STENCIL3 = ("box_blur", "sharpen", "sobel")
OFF_PATH = ("box_blur", "fused_elementwise with a non-empty chain")
# K8's chains in phase 3: every single op, contrast at four factors, and the
# full chain.
FULL_CHAIN = (("invert", 0), ("brightness", 30), ("contrast", 1.5), ("threshold", 128))
CHAINS = [(), (("invert", 0),), (("brightness", 30),), (("brightness", -40),),
          (("threshold", 128),), FULL_CHAIN] + [(("contrast", f),) for f in (0.5, 1.37, 1.5, 2.0)]
# The card's peak rates (NVIDIA's H100 SXM data sheet, at 700 W), per ms:
# HBM3 bytes; float32 operations outside the tensor cores, which also bound
# the integer kernels (their values are integers below 2^24, exact in f32).
# K1's and K9's products may not be contracted into their sums (one FMA
# there moves a truncated or rounded byte), so each counted operation takes a
# whole FP64 issue slot: 132 SMs x 64 lanes x 1.98 GHz, about 16.7 T op/s,
# half the data sheet's 34 TFLOP/s, which counts an FMA as two. K9's product
# is one DFMA that rounds once (an exact addend, csrc/resize.cu::tap): one
# slot, one counted operation.
HBM_BYTES_PER_MS = 3.35e9
F32_OPS_PER_MS = 67e9
F64_UNFUSED_OPS_PER_MS = 17e9
# Operations per output pixel, counted from each kernel's source (an
# integer division by 3 counts as one): gray 3 (two adds, one divide);
# the 5x5 binomial 20 (five multiplies and four adds per pass, two passes,
# and the rounding add and shift); Sobel 34 (11 per gradient, three for m,
# and the root, its rounding and two integer corrections); a histogram 1
# per value. K1 below counts its own.
GRAY_OPS, GAUSS_OPS, SOBEL_OPS = 3, 20, 34
PRESETS = "edge_detect,enhance,print_ready,thumbnail"


def fail(message: str):
    raise RuntimeError(f"chip_smoke: {message}")


def image(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def median_ms(torch, fn, repeats: int = 5) -> float:
    """ms per call of ``fn``: CUDA events around REPS back-to-back calls,
    median over ``repeats`` such runs, after a warm-up call. Where the host
    enqueues slower than the card runs, this is the host's rate."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / REPS)
    return statistics.median(samples)


def bound(nbytes: float, ops: float, ops_per_ms: float = F32_OPS_PER_MS):
    """(least ms on the card, "bytes" or "operations"): the larger of the
    bytes over HBM's rate and the operations over the peak rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_MS, ops / ops_per_ms
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def rotate_cost(torch, rotate, src, angle: float) -> tuple[int, float]:
    """(bytes, f64 operations) of K1 on ``src``: the input read once and the
    output written once; the f64 adds, subtracts and multiplies that the
    reference's arithmetic needs for this input, counting each product of
    the inverse map once per output row or column (cos*xs and -sin*xs per
    column, sin*ys and cos*ys per row: the C rounds them before adding), and
    no pixel that a bound on its tile could settle without them:

    - every pixel in the source: the four adds of (nX, nY);
    - an edge pixel: the two rounding adds of floor(n + 0.5);
    - an interior pixel: per axis the offset n - floor(n) and the three
      others from it (4) and the four Keys weights (6 + 6 + 8 + 8 = 28, in
      the C's order); per channel 16 products and 12 adds for the rows and
      4 and 3 for the column (35).

    Floors and compares are not counted. The zones are counted with K1's
    own geometry on the card."""
    h, w, c = src.shape
    geometry = rotate._geometry(h, w, angle)
    new_h, new_w = geometry[0], geometry[1]
    n_x, n_y = rotate._inverse_map(geometry, torch.arange(new_w, device=src.device),
                                   torch.arange(new_h, device=src.device))
    rx, ry = torch.floor(n_x + 0.5), torch.floor(n_y + 0.5)
    in_bounds = int(((rx >= 0) & (ry >= 0) & (rx < w) & (ry < h)).sum())
    interior = int(((rx > 1) & (ry > 1) & (rx < max(w - 2, 0)) & (ry < max(h - 2, 0))).sum())
    ops = (2.0 * (new_w + new_h) + 4.0 * in_bounds + 2.0 * (in_bounds - interior)
           + interior * (2 * (4 + 28) + 35.0 * c))
    return src.numel() + new_h * new_w * c, ops


def resize_cost(passes, shape) -> tuple[int, float]:
    """(bytes, f64 operations) of K9's two launches on an image of ``shape``
    with the tables ``passes`` (``kernels/resize.py::device_passes``): each
    pass reads its input once and writes its output once (the uint8 image
    between the passes is the reference's own); every output byte takes one
    multiply and one add per tap of its table as it is (pruned columns are
    gone, zero weights that stayed are counted). The tables' bytes, the
    product's addend (one multiply per tap and thread), the rounding add and
    the clamp are not counted."""
    shape = list(shape) + [1] * (3 - len(shape))
    nbytes, ops = 0, 0.0
    for dim, idx, *_ in passes:
        nbytes += shape[0] * shape[1] * shape[2]
        shape[dim] = idx.shape[0]
        out_bytes = shape[0] * shape[1] * shape[2]
        nbytes += out_bytes
        ops += 2.0 * idx.shape[1] * out_bytes
    return nbytes, ops


@contextlib.contextmanager
def ipt_device(name: str):
    """``IPT_DEVICE`` set to ``name`` inside the block."""
    saved = os.environ.get("IPT_DEVICE")
    os.environ["IPT_DEVICE"] = name
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("IPT_DEVICE", None)
        else:
            os.environ["IPT_DEVICE"] = saved


def max_abs_err(torch, a, b) -> int:
    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max())


SPATIAL_CONFIGS = {"-w1920 -r30 -mono -fv": dict(new_width=1920, angle=30.0, mono=True,
                                                   flip_v=True),
                   "-r90": dict(angle=90.0)}


def phase_7(torch, dev, card, drive, path_counts, serve_run, serve_walls, files, bad,
            fanout_flags, n_good, plain_presets) -> list[str]:
    """Spatial and mesh: the band paths on a mesh that names the card four
    times, then ``serve --mesh`` and ``serve --spatial`` over phase 6's
    files. Returns the lines to print."""
    from imageprocessingtools_tpu_torch import parallel
    from imageprocessingtools_tpu_torch.kernels import core, fused
    from imageprocessingtools_tpu_torch.models import PRESETS as PRESET_FNS
    from imageprocessingtools_tpu_torch.parallel import spatial
    from imageprocessingtools_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from imageprocessingtools_tpu_torch.profile_device import device_us_per_call

    card0 = torch.device("cuda", torch.cuda.current_device())
    mesh4 = (card0,) * 4
    configs = {k: PipelineConfig(**v) for k, v in SPATIAL_CONFIGS.items()}
    labels = ["fused", *PRESETS.split(","), *configs]

    def banded(label, src, mesh):
        if label == "fused":
            return spatial.fused_pipeline_spatial(src, mesh)
        if label in configs:
            return spatial.run_pipeline_spatial(src, configs[label], mesh)
        return spatial.preset_pipeline_spatial(src, label, mesh)

    def unsharded(label, src):
        if label == "fused":
            return fused.fused_pipeline_mega(src)
        if label in configs:
            return run_pipeline(src, configs[label])[0]
        return PRESET_FNS[label](src)

    host = image((H4K, W4K, 3), seed=80)
    outs = {}
    # Four bands each: fused K6, K4, K3; edge_detect K6, Sobel; enhance K8, K4,
    # K3, sharpen; print_ready K8, K4, K3; thumbnail and -w1920 two K9 passes
    # of four launches; -r30 K1 in its band form, four launches.
    path_counts["spatial"] = drive(
        "phase 7 spatial",
        {"gray_gauss": 8, "sobel": 4, "sharpen": 4, "fused_elementwise": 8, "histogram": 12,
         "lut_apply": 12, "resize_pass": 16, "rotate": 4},
        lambda: outs.update({label: banded(label, host, mesh4) for label in labels}))
    src = torch.from_numpy(host).to(dev)
    expected = {}
    for label in labels:
        bands = outs[label]
        if any(b.data.device != card0 for b in bands):
            fail(f"spatial {label}: a band left the card")
        got = spatial.gather(bands, card0)
        expected[label] = unsharded(label, src)
        if not torch.equal(got, expected[label]):
            fail(f"spatial {label} differs from the unsharded path on the card by "
                 f"{max_abs_err(torch, got, expected[label])}")
        with ipt_device("cpu"):
            plain = unsharded(label, torch.from_numpy(host))
        if not torch.equal(got.cpu(), plain):
            fail(f"spatial {label} differs from the plain path on the cpu")
    n_bands = {label: len(outs[label]) for label in labels}
    lines = [f"phase 7 spatial: {', '.join(labels)} on {H4K}x{W4K} in bands {n_bands} over a mesh "
             f"of the card x4, byte-equal to the unsharded path on the card and to the plain "
             f"path on the cpu"]

    # Band and unsharded forms side by side, input on the card.
    timed = {"fused": (lambda: spatial.fused_pipeline_spatial(src, mesh4),
                       lambda: fused.fused_pipeline_mega(src)),
             "edge_detect": (lambda: spatial.preset_pipeline_spatial(src, "edge_detect", mesh4),
                             lambda: core.sobel(core.gray_gauss(src)))}
    parts = []
    for label, (band_fn, one_fn) in timed.items():
        ms = (median_ms(torch, band_fn), median_ms(torch, one_fn))
        # A trace that still lost events after profile_device's retries stops the run.
        us = (device_us_per_call(f"spatial {label}", band_fn), device_us_per_call(label, one_fn))
        parts.append(f"{label} ms per call {ms[0]:.4f} / {ms[1]:.4f}, "
                     f"device us {us[0]:.2f} / {us[1]:.2f}")
    lines.append(f"phase 7 times, 4 bands / unsharded, {H4K}x{W4K} on {card}: " + "; ".join(parts))

    # serve --mesh and serve --spatial over phase 6's files (one band and one
    # shard per card), byte-equal to phase 6's outputs.
    def moved_serving():
        for mode in ("--mesh", "--spatial"):
            sfx = "." + mode[2:]
            serve_run(f"{mode} presets",
                      [mode, "--preset", PRESETS, "--skip-bad", "--suffix", sfx, *files, bad])
            serve_run(f"{mode} fanout", [mode, "--fanout", fanout_flags, "--suffix", sfx,
                                         *files[:8]])

    path_counts["serving moved"] = drive(
        "phase 7 serving",
        {"gray_gauss": 2 * n_good, "sobel": 2 * n_good, "sharpen": 2 * n_good,
         "fused_elementwise": 2 * (2 * n_good + 8), "histogram": 4 * n_good,
         "lut_apply": 4 * n_good, "rotate": 16, "resize_pass": 2 * (2 * n_good + 2 * 8)},
        moved_serving)
    n_equal = 0
    for i, path in enumerate(files):
        for tag in list(plain_presets)[:4] + (["gray", "w1920-r30"] if i < 8 else []):
            with open(f"{path}.{tag}.out", "rb") as f:
                want = f.read()
            for mode in ("mesh", "spatial"):
                with open(f"{path}.{tag}.{mode}", "rb") as f:
                    if f.read() != want:
                        fail(f"serve --{mode} {path}.{tag} differs from phase 6's output")
                n_equal += 1
    if os.path.exists(bad + ".edge_detect.spatial"):
        fail("serve --spatial wrote an output for the truncated file")
    lines.append(f"phase 7 serving: --mesh and --spatial wrote {n_equal} outputs byte-equal to "
                 f"phase 6's; wall on {card}: " + ", ".join(
                     f"{label} {wall:.3f} s" for label, (wall, _) in serve_walls.items()
                     if label.startswith("--")))

    # Every card torch sees, where there are several.
    if torch.cuda.device_count() > 1:
        every = parallel.default_mesh()
        for label in labels:
            got = spatial.gather(banded(label, host, every), card0)
            if not torch.equal(got, expected[label]):
                fail(f"spatial {label} over {len(every)} cards differs from the unsharded path")
        batch_in = torch.from_numpy(image((len(every), 1080, 1920, 3), seed=81))
        shards = parallel.batched_fused_pipeline(batch_in, mesh=every)
        for i, shard in enumerate(shards):
            if shard.device != every[i] or not torch.equal(
                    shard[0].to(card0), fused.fused_pipeline(batch_in[i].to(card0))):
                fail(f"batched_fused_pipeline shard {i} over {len(every)} cards is wrong")
        lines.append(f"phase 7 cards: the band paths and a batch over {len(every)} cards "
                     f"byte-equal (copies between cards exercised)")
    else:
        lines.append("phase 7 cards: torch sees one card; copies between cards were not "
                     "exercised")
    return lines


def main() -> int:
    import torch

    # Phase 1: the device.
    print(f"phase 1 device: torch {torch.__version__}, CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)

    sys.path.insert(0, REPO)
    from imageprocessingtools_tpu_torch import cli, device, parallel, serve
    from imageprocessingtools_tpu_torch.codec import native, ppm
    from imageprocessingtools_tpu_torch.kernels import _build, core, fused, rotate
    from imageprocessingtools_tpu_torch.kernels import resize as k9
    from imageprocessingtools_tpu_torch.ops import _exact
    from imageprocessingtools_tpu_torch.ops.color import grayscale
    from imageprocessingtools_tpu_torch.ops.dither import mono_dither
    from imageprocessingtools_tpu_torch.ops.histogram import _equalize_lut
    from imageprocessingtools_tpu_torch.ops.resize import resize, resize_width, resize_width_dense

    dev = device.get_device()
    if dev.type != "cuda":
        fail(f"the configured device is {dev}, not cuda (is IPT_DEVICE set?)")

    wrappers = {
        "rotate": rotate.rotate_bicubic, "gray_gauss_hist": core.gray_gauss_hist,
        "lut_apply": core.lut_apply, "histogram": core.histogram,
        "gaussian_blur": core.gaussian_blur, "gray_gauss": core.gray_gauss,
        "box_blur": core.box_blur, "sharpen": core.sharpen, "sobel": core.sobel,
        "fused_elementwise": core.fused_elementwise, "resize_pass": k9.resize_pass,
    }
    plains = {
        "histogram": core.histogram_plain, "gaussian_blur": core.gaussian_blur_plain,
        "box_blur": core.box_blur_plain, "sharpen": core.sharpen_plain,
        "sobel": core.sobel_plain,
    }

    def drive(phase: str, needs: dict, fn):
        """Run one path with every launch count at 0; return its counts.
        ``needs`` maps each kernel of the path to the fewest launches it
        must make there (one per image that reaches it)."""
        for w in wrappers.values():
            w.launches = 0
        fn()
        torch.cuda.synchronize()
        counts = {name: w.launches for name, w in wrappers.items()}
        short = {name: (counts[name], least) for name, least in needs.items()
                 if counts[name] < least}
        if short:
            fail(f"{phase}: kernels launched fewer times than their path needs "
                 f"(launched, needed): {short}")
        return counts

    # Phase 2: build the kernels from the checkout's sources.
    t0 = time.perf_counter()
    built = not _build.library_path().exists()
    lib_path = _build.build()
    _build.library()
    print(f"phase 2 build: {'built' if built else 'reused'} {os.path.relpath(lib_path, REPO)}"
          f" from {len(_build.sources())} sources in {time.perf_counter() - t0:.2f} s")

    # Phase 3: each kernel against its plain version.
    errs = {name: 0 for name in wrappers}

    def check(name, got, exp, what):
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, exp)
        errs[name] = max(errs[name], err)
        if err:
            fail(f"{name} {what} differs from plain by {err}")

    img4k = torch.from_numpy(image((H4K, W4K, 3), seed=1)).to(dev)
    odd_rgb = torch.from_numpy(image((1001, 1503, 3), seed=7)).to(dev)
    # K1's tiles: near-axis footprints (0.5, 89.5, 179.9, 359.5), the largest
    # (45), whole tiles outside the source (every angle off the axes).
    for src, angle in [
        (img4k, 30.0), (img4k, 135.0),
        (torch.from_numpy(image((1080, 1920), seed=2)).to(dev), 30.0),
        (torch.from_numpy(image((37, 53, 3), seed=3)).to(dev), 117.0),
    ] + [(src, angle) for src in (img4k, odd_rgb)
         for angle in (0.5, 45.0, 89.5, 179.9, 271.0, 359.5)]:
        check("rotate", rotate.rotate_bicubic(src, angle), rotate.rotate_plain(src, angle),
              f"{tuple(src.shape)} at {angle}")
    small = torch.from_numpy(image((5, W4K, 3), seed=4)).to(dev)
    for src in (img4k, small):
        blurred, hist = core.gray_gauss_hist(src)
        exp_blurred, exp_hist = core.gray_gauss_hist_plain(src)
        check("gray_gauss_hist", blurred, exp_blurred, f"{tuple(src.shape)} image")
        check("gray_gauss_hist", hist, exp_hist, f"{tuple(src.shape)} histogram")
    # K2 and K6 at a width whose rows are not 16-byte aligned (3 x 3837 bytes)
    # and on a view that starts 5 bytes into its buffer (their unaligned
    # path), and K2's histogram on a constant image (one hot bin) and a
    # gradient.
    ys = torch.arange(H4K, device=dev)[:, None]
    xs = torch.arange(W4K, device=dev)[None, :]
    flat = torch.empty(img4k.numel() + 5, dtype=torch.uint8, device=dev)
    flat[5:] = img4k.reshape(-1)
    for src, what in [
        (torch.from_numpy(image((H4K, W4K - 3, 3), seed=8)).to(dev), "2160x3837"),
        (flat[5:].view(H4K, W4K, 3), "4K view at byte 5"),
        (torch.full((H4K, W4K, 3), 201, dtype=torch.uint8, device=dev), "4K constant"),
        (((ys + xs) * 255 // (H4K + W4K - 2)).to(torch.uint8)[:, :, None].expand(H4K, W4K, 3)
         .contiguous(), "4K gradient"),
    ]:
        blurred, hist = core.gray_gauss_hist(src)
        exp_blurred, exp_hist = core.gray_gauss_hist_plain(src)
        check("gray_gauss_hist", blurred, exp_blurred, f"{what} image")
        check("gray_gauss_hist", hist, exp_hist, f"{what} histogram")
        if int(hist.sum()) != src.shape[0] * src.shape[1]:
            fail(f"gray_gauss_hist {what}: the histogram counts {int(hist.sum())} pixels")
        check("gray_gauss", core.gray_gauss(src), exp_blurred, what)
    blurred, hist = core.gray_gauss_hist(img4k)
    lut = _equalize_lut(hist, H4K * W4K)
    check("lut_apply", core.lut_apply(blurred, lut), core.lut_apply_plain(blurred, lut), "4K")

    # K6 and K8 at 4K, at the H < 8 shapes of the JAX package's fallback and
    # at an odd width; K8 for every chain, also on a view of an image that
    # holds all 256 gray values (its first 256 pixels are r = g = b = 0..255).
    rgb_inputs = [img4k] + [torch.from_numpy(image(s + (3,), seed=70 + i)).to(dev)
                            for i, s in enumerate([(5, W4K), (1, 1), (7, 53), (37, 101)])]
    for src in rgb_inputs:
        check("gray_gauss", core.gray_gauss(src), core.gray_gauss_plain(src), f"{tuple(src.shape)}")
    grays4k = img4k.clone()
    grays4k.view(-1, 3)[:256] = torch.arange(256, dtype=torch.uint8, device=dev)[:, None]
    view4k = torch.cat([grays4k, grays4k.flip(1)], dim=1)[:, ::2]  # not contiguous
    check("fused_elementwise", grayscale(view4k), core.grayscale_plain(view4k), "grayscale view")
    for chain in CHAINS:
        for src in [grays4k] + rgb_inputs[1:] + [view4k]:
            check("fused_elementwise", core.fused_elementwise(src.contiguous(), chain),
                  core.fused_elementwise_plain(src, chain), f"{tuple(src.shape)} {chain}")

    gray4k = core.grayscale_plain(img4k)
    const4k = torch.full((H4K, W4K), 201, dtype=torch.uint8, device=dev)
    one = torch.from_numpy(image((1, 1), seed=5)).to(dev)
    # Views 5 bytes into a buffer: K4 peels the bytes up to the first 16-byte
    # boundary, K5 stages its rows at their own offset.
    flat_gray = torch.empty(gray4k.numel() + 5, dtype=torch.uint8, device=dev)
    flat_gray[5:] = gray4k.reshape(-1)
    gray_view = flat_gray[5:].view(H4K, W4K)
    gradient4k = ((ys + xs) * 255 // (H4K + W4K - 2)).to(torch.uint8)
    for src, what in ((gray4k, "4K noise"), (const4k, "4K constant"), (one, "1x1"),
                      (gradient4k, "4K gradient"), (gray_view, "4K view at byte 5")):
        hist = core.histogram(src)
        check("histogram", hist, core.histogram_plain(src), what)
        if int(hist.sum()) != src.numel():
            fail(f"histogram {what}: counts {int(hist.sum())} values of {src.numel()}")
    # K7 also at a width that is not a multiple of 16 (its unaligned path).
    stencil_inputs = [gray4k] + [torch.from_numpy(image(s, seed=6 + i)).to(dev)
                                 for i, s in enumerate([(37, 53), (1, 7), (5, 1),
                                                        (H4K, W4K - 3)])]
    edges4k = (gray4k > 127).to(torch.uint8) * 255  # reaches the clips and Sobel's largest m
    # K5 where the halo is taller than the image, and on the unaligned view.
    for src in [gray4k[:h].contiguous() for h in (1, 2, 3, 4)] + [gray_view]:
        check("gaussian_blur", core.gaussian_blur(src), core.gaussian_blur_plain(src),
              f"{tuple(src.shape)} at byte {src.data_ptr() % 16}")
    for name in ("gaussian_blur",) + STENCIL3:
        for src in stencil_inputs + [edges4k]:
            check(name, wrappers[name](src), plains[name](src), f"{tuple(src.shape)}")

    # K9 through resize_width and resize (two launches each) against the two
    # passes of its plain version: the main paths' geometries (4K -> 1920,
    # 8 taps; 4K -> 256, the thumbnail preset, 57 taps; an upscale, 4 taps),
    # a 2-D gray image, odd shapes, fewer source pixels than taps (5x7 -> 2),
    # one row upscaled, and explicit (H, W) targets with one axis up and one
    # down.
    def resize_plain(src, target):
        out = src
        for dim, idx, w, *_ in k9.device_passes(src.shape[0], src.shape[1], target, src.device):
            out = k9.resize_pass_plain(out, idx, w, dim)
        return out

    img1080 = torch.from_numpy(image((1080, 1920, 3), seed=9)).to(dev)
    for src, target in [
        (img4k, 1920), (img4k, 256), (img1080, 3840), (gray4k, 1920),
        (torch.from_numpy(image((1079, 1913, 3), seed=90)).to(dev), 777),
        (torch.from_numpy(image((37, 53, 3), seed=91)).to(dev), 32),
        (torch.from_numpy(image((5, 7, 3), seed=92)).to(dev), 2),
        (torch.from_numpy(image((1, 64, 3), seed=93)).to(dev), 128),
        (img1080, (2160, 960)), (gray4k, (1080, 4096)),
    ]:
        before = k9.resize_pass.launches
        got = resize(src, *target) if isinstance(target, tuple) else resize_width(src, target)
        if k9.resize_pass.launches != before + 2:
            fail(f"resize of {tuple(src.shape)} to {target} made "
                 f"{k9.resize_pass.launches - before} launches, not 2")
        check("resize_pass", got, resize_plain(src, target), f"{tuple(src.shape)} to {target}")

    times = {
        "resize_pass": (median_ms(torch, lambda: resize_width(img4k, 1920)),
                        median_ms(torch, lambda: resize_plain(img4k, 1920))),
        "resize_pass_4k_to_256": (median_ms(torch, lambda: resize_width(img4k, 256)),
                                  median_ms(torch, lambda: resize_plain(img4k, 256))),
        "resize_pass_1080p_to_3840": (median_ms(torch, lambda: resize_width(img1080, 3840)),
                                      median_ms(torch, lambda: resize_plain(img1080, 3840))),
        "rotate": (median_ms(torch, lambda: rotate.rotate_bicubic(img4k, 30.0)),
                   median_ms(torch, lambda: rotate.rotate_plain(img4k, 30.0))),
        "gray_gauss_hist": (median_ms(torch, lambda: core.gray_gauss_hist(img4k)),
                            median_ms(torch, lambda: core.gray_gauss_hist_plain(img4k))),
        "lut_apply": (median_ms(torch, lambda: core.lut_apply(blurred, lut)),
                      median_ms(torch, lambda: core.lut_apply_plain(blurred, lut))),
        "histogram_constant": (median_ms(torch, lambda: core.histogram(const4k)),
                               median_ms(torch, lambda: core.histogram_plain(const4k))),
        "gray_gauss": (median_ms(torch, lambda: core.gray_gauss(img4k)),
                       median_ms(torch, lambda: core.gray_gauss_plain(img4k))),
        "fused_elementwise": (median_ms(torch, lambda: core.fused_elementwise(grays4k)),
                              median_ms(torch, lambda: core.fused_elementwise_plain(grays4k))),
        "fused_elementwise_full_chain": (
            median_ms(torch, lambda: core.fused_elementwise(grays4k, FULL_CHAIN)),
            median_ms(torch, lambda: core.fused_elementwise_plain(grays4k, FULL_CHAIN))),
    }
    for name in plains:
        times[name] = (median_ms(torch, lambda: wrappers[name](gray4k)),
                       median_ms(torch, lambda: plains[name](gray4k)))
    # The one PyTorch call that computes the same function, where there is
    # one: bincount for K4, and for K9 the JAX package's dense form (two
    # float32 matrix products by weight matrices that are already on the
    # card; within 2 of K9's bytes, checked here). The others have none (the
    # plain versions are several calls each). Timed here only, never used by
    # the port.
    dense_err = max_abs_err(torch, resize_width_dense(img4k, 1920), resize_width(img4k, 1920))
    if dense_err > 2:
        fail(f"resize_width_dense differs from resize_width by {dense_err} (> 2)")
    library = {"histogram": median_ms(torch, lambda: torch.bincount(gray4k.reshape(-1),
                                                                     minlength=256)),
               "resize_pass": median_ms(torch, lambda: resize_width_dense(img4k, 1920))}
    # Least times of the timed 4K calls, from their bytes (each input read
    # once, each output written once) and operations.
    px = H4K * W4K
    bounds = {
        "rotate": bound(*rotate_cost(torch, rotate, img4k, 30.0), F64_UNFUSED_OPS_PER_MS),
        "gray_gauss_hist": bound(4 * px + 256 * 4, (GRAY_OPS + GAUSS_OPS + 1) * px),
        "lut_apply": bound(2 * px + 256, 0),
        "histogram": bound(px + 256 * 4, px),
        "gaussian_blur": bound(2 * px, GAUSS_OPS * px),
        "gray_gauss": bound(4 * px, (GRAY_OPS + GAUSS_OPS) * px),
        "stencil3": bound(2 * px, SOBEL_OPS * px),
        "fused_elementwise": bound(4 * px, GRAY_OPS * px),
    }
    # K9's least times: the three timed geometries (the first is the entry's)
    # and 4K gray -> 1920, which profile_device.py times.
    resize_bounds = {
        name: bound(*resize_cost(k9.device_passes(src.shape[0], src.shape[1], target, dev),
                                 src.shape), F64_UNFUSED_OPS_PER_MS)
        for name, src, target in (("resize_pass", img4k, 1920),
                                  ("resize_pass_4k_to_256", img4k, 256),
                                  ("resize_pass_1080p_to_3840", img1080, 3840),
                                  ("resize_pass_4k_gray_to_1920", gray4k, 1920))}
    bounds["resize_pass"] = resize_bounds["resize_pass"]
    # K1's least time at the other angles that profile_device.py times.
    rotate_bounds = {angle: bound(*rotate_cost(torch, rotate, img4k, angle), F64_UNFUSED_OPS_PER_MS)
                     for angle in (45.0, 135.0)}
    print("phase 3 kernels byte-equal to plain at 4K and odd shapes; ms per call at 4K "
          f"(kernel / plain) on {card}: "
          + ", ".join(f"{k} {a:.4f} / {b:.4f}" for k, (a, b) in times.items())
          + "; least ms: " + ", ".join(f"{k} {b:.4f} ({by})" for k, (b, by) in bounds.items())
          + "".join(f", rotate at {a:g} {b:.4f} ({by})" for a, (b, by) in rotate_bounds.items())
          + "".join(f", {k} {b:.4f} ({by})" for k, (b, by) in list(resize_bounds.items())[1:])
          + f"; torch.bincount {library['histogram']:.4f}; resize_width_dense at 4K -> 1920 "
          f"{library['resize_pass']:.4f} (max |dense - K9| {dense_err})")

    tmp = tempfile.mkdtemp(prefix="ipt_chip_smoke_")
    try:
        # Phase 4: the CLI over four 4K files.
        rot30 = _exact.calc_rot_size(30.0, W4K, H4K)             # (w, h)
        rot30_1080 = _exact.calc_rot_size(30.0, 1920, 1080)
        rot135 = _exact.calc_rot_size(_exact.fold_angle(135.0), W4K, H4K)
        # The last two runs are the same flags on two files: the first makes
        # the resize tables and uploads them (the cache is emptied before it),
        # the second finds them on the card.
        runs = [
            (["-r30"], ppm.FILETYPE_PPM, rot30),
            (["-w1920", "-r30", "-gray"], ppm.FILETYPE_PGM, rot30_1080),
            (["-r135", "-mono", "-fh"], ppm.FILETYPE_PBM, rot135),
            (["-w1920"], ppm.FILETYPE_PPM, (1920, 1080)),
            (["-w1920"], ppm.FILETYPE_PPM, (1920, 1080)),
        ]
        cli_paths = []
        for i in range(len(runs)):
            cli_paths.append(os.path.join(tmp, f"frame{i}.ppm"))
            ppm.write_ppm(cli_paths[-1], image((H4K, W4K, 3), seed=10 + i))
        walls, splits = [], []

        def cli_runs():
            """Each run with cli's stages timed on the host clock, each
            ending in a synchronize: decode (read_ppm), the resize plan and
            its tables' upload (device_passes), the image's upload and the
            device stages (the rest of run_pipeline), the download (between
            run_pipeline's return and write_ppm's call), encode and write."""
            split, marks = {}, {}
            originals = {(cli, "read_ppm"): "decode_s", (k9, "device_passes"): "plan_and_tables_s",
                         (cli, "run_pipeline"): "upload_and_device_s",
                         (cli, "write_ppm"): "encode_and_write_s"}

            def timed(fn, key):
                def wrapper(*args, **kwargs):
                    t0 = time.perf_counter()
                    if key == "encode_and_write_s":
                        split["download_s"] = t0 - marks["pipeline_end"]
                    out = fn(*args, **kwargs)
                    torch.cuda.synchronize()
                    split[key] = split.get(key, 0.0) + time.perf_counter() - t0
                    marks["pipeline_end"] = time.perf_counter()
                    return out
                return wrapper

            saved = {(mod, name): getattr(mod, name) for mod, name in originals}
            for (mod, name), key in originals.items():
                setattr(mod, name, timed(saved[mod, name], key))
            try:
                for i, (path, (flags, _, _)) in enumerate(zip(cli_paths, runs)):
                    if flags == ["-w1920"] and runs[i - 1][0] != flags:
                        saved[k9, "device_passes"].cache_clear()
                    split.clear()
                    t0 = time.perf_counter()
                    rc = cli.main(flags + [path])
                    walls.append(time.perf_counter() - t0)
                    if rc != 0:
                        fail(f"cli {flags} exited {rc}")
                    split["upload_and_device_s"] -= split.get("plan_and_tables_s", 0.0)
                    splits.append(dict(split))
            finally:
                for (mod, name), fn in saved.items():
                    setattr(mod, name, fn)

        n_rotating = sum(any(f.startswith("-r") for f in flags) for flags, _, _ in runs)
        n_resizing = sum(any(f.startswith("-w") for f in flags) for flags, _, _ in runs)
        # -w1920 -r30 -gray runs K8 (grayscale) once; a resize is two K9 launches.
        k9.device_passes.cache_clear()
        path_counts = {"cli": drive(
            "phase 4 cli",
            {"rotate": n_rotating, "fused_elementwise": 1, "resize_pass": 2 * n_resizing},
            cli_runs)}
        for path, (flags, file_type, (out_w, out_h)) in zip(cli_paths, runs):
            with open(path + ".out", "rb") as f:
                out, _, got_type = ppm.decode_pnm(f.read())
            if got_type != file_type or out.shape[:2] != (out_h, out_w):
                fail(f"cli {flags}: type {got_type} shape {out.shape}, "
                     f"want type {file_type} shape {(out_h, out_w)}")
        # Cross-check a smaller file against the same CLI on the CPU.
        small_img = image((768, 1024, 3), seed=20)
        # Byte for byte: the port has no inexact stage.
        worst = {}
        for flags in (("-w640", "-r30", "-gray"), ("-r135", "-mono")):
            outs = []
            for where in ("cuda", "cpu"):
                path = os.path.join(tmp, f"small_{where}.ppm")
                ppm.write_ppm(path, small_img)
                if where == "cuda":
                    rc = cli.main(list(flags) + [path])
                else:
                    env = dict(os.environ, IPT_DEVICE="cpu")
                    rc = subprocess.run(
                        [sys.executable, "-m", f"{PKG}.cli", *flags, path],
                        cwd=REPO, env=env, timeout=600,
                    ).returncode
                if rc != 0:
                    fail(f"cli {flags} on {where} exited {rc}")
                with open(path + ".out", "rb") as f:
                    outs.append(f.read())
            a, b = (ppm.decode_pnm(o)[0].astype(np.int32) for o in outs)
            if a.shape != b.shape:
                fail(f"cli {flags}: cuda shape {a.shape} != cpu shape {b.shape}")
            worst[" ".join(flags)] = int(np.abs(a - b).max())
            if outs[0] != outs[1]:
                fail(f"cli {flags}: cuda and cpu outputs differ by {worst[' '.join(flags)]}")
        print("phase 4 cli: " + ", ".join(
            f"{' '.join(flags)} {wall:.3f} s" for (flags, _, _), wall in zip(runs, walls))
            + f" per 4K file; 768x1024 cuda and cpu outputs byte-equal {worst}")
        for (flags, _, _), wall, split in zip(runs, walls, splits):
            print(f"phase 4 cli split of {' '.join(flags)} ({wall:.4f} s): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))

        # Phase 5: the flagship at 4K, through K2 and K3, and staged through K8, K5, K4, K3.
        flagship = torch.from_numpy(image((H4K, W4K, 3), seed=30)).to(dev)
        results = {}

        def flagships():
            results["mega"] = fused.fused_pipeline_mega(flagship)
            results["staged"] = fused.fused_pipeline_staged(flagship)

        path_counts["flagship"] = drive(
            "phase 5 flagship",
            {"gray_gauss_hist": 1, "lut_apply": 2, "fused_elementwise": 1, "gaussian_blur": 1,
             "histogram": 1},
            flagships)
        plain = fused.fused_pipeline(flagship)
        for form, out in results.items():
            if out.dtype != torch.uint8 or tuple(out.shape) != (H4K, W4K):
                fail(f"flagship {form} gave {out.dtype} {tuple(out.shape)}")
            if not torch.equal(out, plain):
                fail(f"flagship {form} differs from plain by {max_abs_err(torch, out, plain)}")
        mega_ms = median_ms(torch, lambda: fused.fused_pipeline_mega(flagship))
        staged_ms = median_ms(torch, lambda: fused.fused_pipeline_staged(flagship))
        plain_ms = median_ms(torch, lambda: fused.fused_pipeline(flagship))
        print(f"phase 5 flagship 2160x3840 mega and staged byte-equal to plain; ms per call "
              f"mega {mega_ms:.3f} ({H4K * W4K / mega_ms / 1e3:.1f} MPix/s), staged "
              f"{staged_ms:.3f}, plain {plain_ms:.3f} on {card}")

        # The batch module: four 4K images through the mega form, K2 and K3
        # once per image, each output byte-equal to the plain pipeline's.
        batch_in = torch.from_numpy(image((4, H4K, W4K, 3), seed=31))
        path_counts["batch"] = drive(
            "phase 5 batch", {"gray_gauss_hist": 4, "lut_apply": 4},
            lambda: results.update(batch=parallel.batched_fused_pipeline(batch_in)))
        batch_out = results.pop("batch")
        if batch_out.dtype != torch.uint8 or tuple(batch_out.shape) != (4, H4K, W4K):
            fail(f"batched_fused_pipeline gave {batch_out.dtype} {tuple(batch_out.shape)}")
        if batch_out.device.type != "cuda":
            fail(f"batched_fused_pipeline ran on {batch_out.device}")
        for i in range(4):
            if not torch.equal(batch_out[i], fused.fused_pipeline(batch_in[i].to(dev))):
                fail(f"batched_fused_pipeline image {i} differs from the plain pipeline")
        print("phase 5 batch: batched_fused_pipeline on uint8[4, 2160, 3840, 3] byte-equal to "
              "four plain pipelines")

        # Phase 6: preset serving.
        if not native.available():
            fail("the native codec did not build (g++)")
        serve_dir = os.path.join(tmp, "serve")
        os.makedirs(serve_dir)
        shapes = [(H4K, W4K)] * 8 + [(1080, 1920)] * 2
        files = []
        for i, (h, w) in enumerate(shapes):
            files.append(os.path.join(serve_dir, f"f{i}.ppm"))
            ppm.write_ppm(files[-1], image((h, w, 3), seed=40 + i))
        bad = os.path.join(serve_dir, "truncated.ppm")
        with open(bad, "wb") as f:
            f.write(b"P6\n64 64\n255\n" + bytes(100))
        serve_walls = {}

        def serve_run(label, argv):
            err = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                rc = serve.main(argv)
            torch.cuda.synchronize()
            serve_walls[label] = (time.perf_counter() - t0, err.getvalue().strip())
            if rc != 0:
                fail(f"serve {label} exited {rc}: {err.getvalue()}")
            return err.getvalue()

        fanout_flags = "-gray;-w1920 -r30"

        def serving_runs():
            serve_run("presets", ["--preset", PRESETS, "--skip-bad", *files, bad])
            serve_run("fanout", ["--fanout", fanout_flags, *files[:8]])

        # Per good file: edge_detect one K6 and one Sobel, enhance one K8, one
        # K4, one K3 and one sharpen, print_ready one K8, one K4 and one K3,
        # thumbnail two K9; the fan-out one K8 (-gray), two K9 (-w1920) and one
        # K1 per 4K file.
        n_good = len(files)
        path_counts["serving"] = drive(
            "phase 6 serving",
            {"gray_gauss": n_good, "sobel": n_good, "sharpen": n_good,
             "fused_elementwise": 2 * n_good + 8, "histogram": 2 * n_good,
             "lut_apply": 2 * n_good, "rotate": 8, "resize_pass": 2 * n_good + 2 * 8},
            serving_runs)
        if f"skipped {bad}: Error: unexpected end of file." not in serve_walls["presets"][1]:
            fail(f"serve did not report the truncated file: {serve_walls['presets'][1]}")

        def equalize_plain(g):
            return core.lut_apply_plain(g, _equalize_lut(core.histogram_plain(g), g.numel()))

        gray_plain = core.grayscale_plain
        plain_presets = {  # the presets' plain bodies, unpacked
            "edge_detect": lambda im: core.sobel_plain(core.gray_gauss_plain(im)),
            "enhance": lambda im: core.sharpen_plain(equalize_plain(gray_plain(im))),
            "print_ready": lambda im: mono_dither(
                equalize_plain(gray_plain(im))[..., None].expand(im.shape)),
            "thumbnail": lambda im: resize_plain(im, 256),
            "gray": gray_plain,
            "w1920-r30": lambda im: rotate.rotate_plain(resize_plain(im, 1920), 30.0),
        }
        want_types = {"edge_detect": ppm.FILETYPE_PGM, "enhance": ppm.FILETYPE_PGM,
                      "print_ready": ppm.FILETYPE_PBM, "thumbnail": ppm.FILETYPE_PPM,
                      "gray": ppm.FILETYPE_PGM, "w1920-r30": ppm.FILETYPE_PPM}
        n_checked = 0
        for i, path in enumerate(files):
            with open(path, "rb") as f:
                src = torch.from_numpy(ppm.decode_ppm(f.read())[0]).to(dev)
            tags = PRESETS.split(",") + (["gray", "w1920-r30"] if i < 8 else [])
            for tag in tags:
                with open(f"{path}.{tag}.out", "rb") as f:
                    got, _, got_type = ppm.decode_pnm(f.read())
                exp = plain_presets[tag](src).cpu().numpy()
                if got_type != want_types[tag] or got.shape != exp.shape:
                    fail(f"serve {path}.{tag}: type {got_type} shape {got.shape}, want "
                         f"type {want_types[tag]} shape {exp.shape}")
                if not np.array_equal(got, exp):
                    fail(f"serve {path}.{tag} differs from the plain body")
                n_checked += 1
        if os.path.exists(bad + ".edge_detect.out"):
            fail("serve wrote an output for the truncated file")

        # Cross-check one smaller file against the same serve on the CPU.
        small_serve = image((768, 1024, 3), seed=60)
        cross_args = ["--preset", PRESETS, "--fanout", "-gray;-w640 -r30"]
        cross = {}
        for where in ("cuda", "cpu"):
            path = os.path.join(tmp, f"serve_small_{where}.ppm")
            ppm.write_ppm(path, small_serve)
            if where == "cuda":
                serve_run("768x1024", cross_args + [path])
            else:
                env = dict(os.environ, IPT_DEVICE="cpu")
                rc = subprocess.run([sys.executable, "-m", f"{PKG}.serve", *cross_args, path],
                                    cwd=REPO, env=env, timeout=600, capture_output=True).returncode
                if rc != 0:
                    fail(f"serve on the cpu exited {rc}")
            for tag in PRESETS.split(",") + ["gray", "w640-r30"]:
                with open(f"{path}.{tag}.out", "rb") as f:
                    cross.setdefault(tag, []).append(f.read())
        cross_worst = {}  # byte for byte, resize chains included
        for tag, (on_cuda, on_cpu) in cross.items():
            a, b = (ppm.decode_pnm(o)[0].astype(np.int32) for o in (on_cuda, on_cpu))
            if a.shape != b.shape:
                fail(f"serve {tag}: cuda shape {a.shape} != cpu shape {b.shape}")
            cross_worst[tag] = int(np.abs(a - b).max())
            if on_cuda != on_cpu:
                fail(f"serve {tag}: cuda and cpu outputs differ by {cross_worst[tag]}")

        # Phase 7: spatial and mesh.
        phase7 = phase_7(torch, dev, card, drive, path_counts, serve_run, serve_walls, files,
                         bad, fanout_flags, n_good, plain_presets)
    finally:
        shutil.rmtree(tmp)
    for label, n_files in (("presets", len(files)), ("fanout", 8)):
        wall = serve_walls[label][0]
        print(f"phase 6 serving {label}: {n_files} files in {wall:.3f} s "
              f"({n_files / wall:.2f} files/s) on {card}; serve said: "
              f"{serve_walls[label][1].splitlines()[-1]}")
    print(f"phase 6 serving: {n_checked} outputs byte-equal to the plain bodies on the card; "
          f"768x1024 cuda and cpu outputs byte-equal {cross_worst}; native codec built")
    for line in phase7:
        print(line)
    print("launches per path (counts set to 0 before each): "
          + "; ".join(f"{p} {c}" for p, c in path_counts.items())
          + f"; {' and '.join(OFF_PATH)} are on no path (phase 3 holds them to plain)")

    launches = {name: sum(c[name] for c in path_counts.values()) for name in wrappers}
    k7 = {name: {"launches": launches[name], "on_path": name not in OFF_PATH,
                 "max_abs_err": errs[name], "ms": times[name][0], "plain_ms": times[name][1]}
          for name in STENCIL3}
    entries = []
    for name, (source, replaces) in KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{source}",
                 "replaces": replaces, "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                 "library_ms": library.get(name)}
        if name == "stencil3":  # K7: one template, three instances; Sobel's times
            entry.update(launches=sum(k["launches"] for k in k7.values()),
                         max_abs_err=max(k["max_abs_err"] for k in k7.values()),
                         ms=k7["sobel"]["ms"], plain_ms=k7["sobel"]["plain_ms"], instances=k7)
        else:
            entry.update(launches=launches[name], max_abs_err=errs[name],
                         ms=times[name][0], plain_ms=times[name][1])
        if name == "histogram":
            entry.update(constant_ms=times["histogram_constant"][0],
                         constant_plain_ms=times["histogram_constant"][1])
        if name == "resize_pass":  # two launches per resize; the entry's times are 4K -> 1920
            for key in ("resize_pass_4k_to_256", "resize_pass_1080p_to_3840"):
                case = key[len("resize_pass_"):]
                entry.update({f"{case}_ms": times[key][0], f"{case}_plain_ms": times[key][1],
                              f"{case}_bound_ms": resize_bounds[key][0],
                              f"{case}_bound_by": resize_bounds[key][1]})
        if name == "fused_elementwise":  # off the paths: the full chain
            entry.update(full_chain_ms=times["fused_elementwise_full_chain"][0],
                         full_chain_plain_ms=times["fused_elementwise_full_chain"][1])
        entries.append(entry)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
