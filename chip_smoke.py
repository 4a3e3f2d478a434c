#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card, and check them.

Run from the root of the repository, with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``imageprocessingtools_tpu_torch/csrc``
(nvcc, sm_90a, one process per source, into the port's cache directory:
``$IPT_CACHE_DIR``, the checkout's ``.cache/`` or the user's cache) and runs,
in order, printing one line per phase:

1. the device: torch and CUDA versions, the card's name and power limit;
2. the kernel build, with its seconds;
3. each kernel against its plain torch version on the same CUDA tensors at
   the main paths' shapes and at odd ones (byte-equal required), with each
   one's ms per call at 4K (CUDA events around 20 back-to-back calls, median
   of 5 such runs), its least time on the card from the bytes and operations
   of that 4K call, and the time of the one PyTorch call that computes the
   same function, where there is one (K9, the resize pass, is checked and
   timed through ``resize_width`` and ``resize``, two launches each); then
   the batch axis (``jax.vmap``'s one kernel over the batch): K2/K6, K4, K3,
   K7, K1 (30 and 135 degrees) and K9 (each pass) over uint8[N, ...] in one
   launch, each byte-equal to its plain batch version and to its
   single-image kernel image by image, on uint8[4, 2160, 3840(, 3)] and odd
   batches (3 x 37 x 53, heights below the halo, 64 x 512 x 512, a batch of
   one, constant images among noise, a view 5 bytes into its buffer), K9
   also at 4K x 4 to 1920 and 256 and at 1080p x 2 to 3840, RGB and gray,
   K8 on uint8[4, 2160, 3840, 3], with ms per call at 4K x 4 beside the
   single-image kernel on each image and the least time; then K10,
   print_ready's dither and P4 packing in one pass, against its plain
   version (today's ten torch launches) at 4K x 10, 3 x 120 x 203, one
   byte into its buffer and on every byte value at every Bayer position,
   with ms per call and the card's time of both beside the least time;
4. the CLI (``imageprocessingtools_tpu_torch.cli.main``) over four 4K P6
   files, each run split into decode, resize plan and table upload, upload
   and device, download, and encode and write (``-w1920`` twice: its first
   call makes and uploads the tables, its second finds them on the card),
   with a byte-for-byte cross-check of a smaller file against the same CLI
   run on the CPU in a subprocess (``IPT_DEVICE=cpu``);
5. the flagship fused pipeline at 4K through K2 and K3, and its staged form
   through K8, K5, K4 and K3, eager and compiled (the CUDA graphs
   ``kernels.fused_gray_gauss_histeq_pallas_mega`` and ``..._pallas``, the
   JAX package's ``jax.jit`` forms), each byte-equal to the plain torch
   pipeline: the compiled forms also to the eager ones at 4K and 1081x1927
   on two inputs in turn, the first output unchanged by the second call and
   never the graph's own buffer; ms per call of the four, and the graphs'
   copy-in and clone; mega's ``utils.timing.device_loop_rate`` (its loop one
   CUDA graph) and ``dispatch_time`` (one replay) beside its device us, eager
   and graphed (traced in phase 7, printed after it), the loop rate held to
   [0.8, 2.5] times the eager device time; then a batch of four 4K images
   through ``parallel.batched_fused_pipeline``, one replay of a captured
   graph of the four (``utils.graphs.batched``, the JAX package's
   ``jax.jit(jax.vmap(fn))``) through the mega form's batch form: K2 and K3
   launched exactly once each over the four (the counts show it, or the run
   fails), byte-equal to the eager loop (``graphs.eager_batch``) and to the
   plain pipeline per image;
6. preset serving (``imageprocessingtools_tpu_torch.serve.main``), each
   chunk one replay per group of G images: the four presets fanned out over
   eight 4K and two 1080p P6 files and one truncated file (``--skip-bad``),
   every output byte-equal to the presets' plain bodies and to the eager
   loop on the same decoded images on the card; a reference-flag fan-out
   over the 4K files; a byte-for-byte cross-check of a smaller file against
   the same ``serve`` run on the CPU in a subprocess; every task's kernels
   launched once per group (their batch forms: K6, K7, K4, K3, K8, K1 and
   K9 over the group, none image by image, in the counts and in each
   graph's record);
   G, the graphs kept, their bytes against ``graphs.GRAPH_BYTES_BOUND`` and
   their capture seconds; per preset and for the fan-out, ms per chunk of
   eight 4K images on the card, eager loop against graphed (CUDA events);
   the batch forms against the per-image graphs of the same bodies (mega at
   4K x 10, 1080p x 8, 1366x768 x 16 and 512x512 x 64; edge_detect, enhance,
   print_ready, thumbnail and ``-r30`` at 4K x 8 and 512x512 x 64;
   ``-w1920``, ``-w1920 -r30 -gray`` and a fan-out of reference configs at
   4K x 8; ``-mono -fh`` at 512x512 x 64): ms per group and device us per
   image, byte-equal, each kernel once per group against once per image (a
   resize's K9 twice); and ``serve
   --sequential``'s split (decode, upload and device, download, encode) and
   the overlapped serves' walls in three turns (``serving_turns.py`` times
   them beside another checkout's);
7. spatial and mesh (``parallel/spatial.py``): on a 4K noise image, with a
   mesh that names the card four times (four row bands), the fused pipeline,
   the four presets, ``-w1920 -r30 -mono -fv``, ``-r90``, ``-w1920``,
   ``-r30`` and ``-r180``, each one CUDA graph (the band pipelines' compiled
   form, the JAX package's ``jax.jit(shard_map(...))``), byte-equal to the
   unsharded path on the card and (the fused pipeline, the presets, the
   first two configs) to the plain path on the CPU (K1 runs in its band
   form there); each of these in 1 and 4 bands compiled and eager (the bands
   views of the input), byte-equal to each other and to the unsharded path,
   with ms per call of both (CUDA events); the fused pipeline and
   edge_detect in 4 bands traced eager, compiled and eager over bands that
   are separate copies (device us, and of it the window joins,
   ``torch.cat``'s kernels) beside the unsharded form (the flagship mega is
   traced by ``utils.profiling.trace_to`` with 20 calls in a ``span``,
   read with ``profile_device.device_events``, and the trace must hold
   the span and 20 times one call's device events, or the run
   fails); the band graphs' bytes and capture seconds; uint8[16384, 16384,
   3] of numpy noise, the fused pipeline and edge_detect compiled in 4
   bands against the unsharded compiled path (``kernels.fused_gray_gauss_
   histeq_pallas_mega``, ``graphs.graphed`` of the preset), with ms per
   call and graph bytes, and ``serve --spatial``'s fan-out of the presets
   against its eager band form; then ``serve --mesh`` and ``serve
   --spatial`` over phase 6's files (``--mesh`` replaying the card's
   graphs), and ``serve --spatial`` again, which must capture nothing, all
   byte-equal to phase 6's outputs, with the graphs kept against
   ``graphs.GRAPH_BYTES_BOUND``. Where torch sees more than one card, the
   spatial paths (eager there) and a batch also run over a mesh of every
   card (copies between cards); otherwise the line says that they were not
   exercised;
8. images of 2^31 bytes and more, made on the card from a seeded
   ``torch.Generator``: K1 (30 degrees), K2 and K6 on uint8[27000, 27000, 3],
   K5 and K7 (Sobel) on uint8[46341, 46341], each one launch; output rows
   whose offsets, or whose source rows' offsets, pass 2^31 held byte-equal
   to the plain versions on the same window, K2's histogram to
   ``torch.bincount``, and each kernel's time per call (CUDA events).

Every kernel's launch count (the batched wrappers' too) is set to 0 just
before each of phases 4, 5 (the flagship, then the batch), 6 and 7 (the
band paths, then the moved serving)
and read just after it; a kernel that a phase's path uses and that was not
launched there is a failure. A wrapper counts where it launches its kernel;
a CUDA graph's replay launches without calling the wrappers, so a capture
records the counts that its wrappers added (and takes them back: a capture
launches nothing), and each replay adds them again (``utils/graphs.py``).
Phase 5's flagship path replays graphs captured before its counts are set
to 0, and needs each kernel twice: once eager, once from the replay. The
line before the last is a JSON object with
each kernel's launches (summed over the four paths), error, times, least
time and the PyTorch call's time (and, for the kernels of phase 8, what it
checked and timed there); the last line is
``{"ok": true, "device": {...}}``. Any failure raises, and the
script then exits non-zero without printing either line.
"""

from __future__ import annotations

import collections
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
# The batch axis (jax.vmap's one kernel over the batch): each batched wrapper
# -> the kernel whose source and Pallas function it shares.
BATCH_KERNELS = {"gray_gauss_hist_batch": "gray_gauss_hist", "gray_gauss_batch": "gray_gauss",
                 "histogram_batch": "histogram", "lut_apply_batch": "lut_apply",
                 "stencil3_batch": "stencil3", "rotate_batch": "rotate",
                 "resize_pass_batch": "resize_pass"}
# K7's instances: the template's three wrappers. Box is on no path (no preset
# uses it), nor is K8 with a non-empty chain (the paths run it with the
# empty chain, as grayscale); phase 3 holds both to their plain versions.
STENCIL3 = ("box_blur", "sharpen", "sobel")
STENCIL3_BATCH = tuple(f"{name}_batch" for name in STENCIL3)
OFF_PATH = ("box_blur", "box_blur_batch", "fused_elementwise with a non-empty chain")
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


def median_ms(torch, fn, repeats: int = 5, reps: int = REPS) -> float:
    """ms per call of ``fn``: CUDA events around ``reps`` (REPS) back-to-back
    calls, median over ``repeats`` such runs, after a warm-up call. Where the
    host enqueues slower than the card runs, this is the host's rate."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
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
    own geometry on the card, 1024 output rows at a time."""
    h, w, c = src.shape
    geometry = rotate._geometry(h, w, angle)
    new_h, new_w = geometry[0], geometry[1]
    in_bounds = interior = 0
    for y0 in range(0, new_h, 1024):
        n_x, n_y = rotate._inverse_map(geometry, torch.arange(new_w, device=src.device),
                                       torch.arange(y0, min(y0 + 1024, new_h), device=src.device))
        rx, ry = torch.floor(n_x + 0.5), torch.floor(n_y + 0.5)
        in_bounds += int(((rx >= 0) & (ry >= 0) & (rx < w) & (ry < h)).sum())
        interior += int(((rx > 1) & (ry > 1) & (rx < max(w - 2, 0))
                         & (ry < max(h - 2, 0))).sum())
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
                   "-r90": dict(angle=90.0), "-w1920": dict(new_width=1920),
                   "-r30": dict(angle=30.0), "-r180": dict(angle=180.0)}
PLAIN_CONFIGS = ("-w1920 -r30 -mono -fv", "-r90")  # also held to the plain path on the cpu
GIANT = (16384, 16384, 3)  # 805,306,368 bytes


def at_byte(torch, x, offset: int):
    """A contiguous copy of ``x`` that starts ``offset`` bytes into its buffer."""
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    flat[offset:] = x.reshape(-1)
    return flat[offset:].view(x.shape)


# Phase 3's batched kernels: 4K x 4 (timed), and odd batches: W % 16 != 0
# and H * W % 16 != 0 (3 x 37 x 53), heights below the halo, a 1080p-like
# odd shape, more 512x512 images than the card has SMs, and a batch of one.
BATCH_N = 4
BATCH_SHAPES = [(BATCH_N, H4K, W4K), (3, 37, 53), (7, 5, 3840), (2, 1081, 1927), (64, 512, 512),
                (1, 29, 130)]


# K10's cases: a group of ten 4K images, rows of 26 bytes with 5 pad bits, and
# H not a multiple of 4.
DITHER_N = 10


def phase_3_dither_pack(torch, dev, card, check) -> tuple[str, dict]:
    """K10 (print_ready's Bayer dither and P4 packing in one pass) against its
    plain version, today's ten torch launches, on gray uint8[10, 2160, 3840],
    3 x 120 x 203 (rows of 26 bytes, 5 pad bits), a view one byte into its
    buffer (the byte path) and a frame of every byte value at every Bayer
    position (1024 x 16, and 13 wide). Returns the line to print and the
    kernel's JSON entry but its launches and error: ms per call at 4K x 10
    (K10 / plain), the card's ms of each from a CUDA graph replay, and the
    least time (the gray read once, the rows written once)."""
    from imageprocessingtools_tpu_torch.kernels import core
    from imageprocessingtools_tpu_torch.utils import graphs

    gen = torch.Generator(device=dev)
    gen.manual_seed(27)
    group = torch.randint(0, 256, (DITHER_N, H4K, W4K), generator=gen, device=dev,
                          dtype=torch.uint8)
    small = torch.randint(0, 256, (3, 120, 203), generator=gen, device=dev, dtype=torch.uint8)
    every = (torch.arange(1024, device=dev) // 4).to(torch.uint8)[None, :, None].expand(
        1, 1024, 16).contiguous()
    cases = {f"{DITHER_N}x{H4K}x{W4K}": group, "3x120x203": small,
             f"2x{H4K}x{W4K} at byte 1": at_byte(torch, group[:2], 1),
             "3x120x203 at byte 1": at_byte(torch, small, 1),
             "every value 1x1024x16": every, "every value 1x1024x13": every[..., :13].contiguous()}
    for what, x in cases.items():
        check("dither_pack_batch", core.dither_pack_batch(x), core.dither_pack_batch_plain(x), what)
    calls = (lambda: core.dither_pack_batch(group), lambda: core.dither_pack_batch_plain(group))
    ms = tuple(median_ms(torch, fn) for fn in calls)
    device_ms = tuple(median_ms(torch, graphs.capture(lambda _, fn=fn: fn(), group).replay)
                      for fn in calls)
    least, by = bound(DITHER_N * H4K * (W4K + W4K // 8), 0)
    line = (f"phase 3 K10: dither_pack_batch byte-equal to its plain version (the ten torch "
            f"launches it replaces) on {', '.join(cases)}; on uint8[{DITHER_N}, {H4K}, {W4K}] "
            f"on {card}: ms per call (K10 / plain) {ms[0]:.4f} / {ms[1]:.4f}, the card's ms "
            f"(each call a CUDA graph, replayed) {device_ms[0]:.4f} / {device_ms[1]:.4f}; "
            f"least {least:.4f} ms ({by}): K10 at {100 * least / device_ms[0]:.1f}%")
    entry = {"name": "dither_pack_batch", "route": "cuda",
             "source": f"{PKG}/csrc/dither_pack.cu", "replaces": None, "batch": DITHER_N,
             "bound_ms": least, "bound_by": by, "library_ms": None, "ms": ms[0],
             "plain_ms": ms[1], "device_ms": device_ms[0], "plain_device_ms": device_ms[1]}
    return line, entry


def phase_3_batch(torch, dev, card, check) -> tuple[str, dict, dict]:
    """Each batched kernel (K2/K6, K4, K3, K7, K1 and K9 over uint8[N, ...]
    in one launch) against its plain batch version and against its
    single-image kernel image by image, on ``BATCH_SHAPES`` of noise, noise
    and constant images in turn, and a view 5 bytes into its buffer (K1 at
    30 and 135 degrees; K9 to half the width plus one, and at 4K to 1920 and
    256 and at 1080p to 3840, RGB and gray, each pass); K8 (no batch entry:
    it takes uint8[..., 3]) on the 4K batch. Returns the line to print, ms
    per call at 4K x 4 (batched, plain batch, the single-image kernel on each
    image in turn; then the card's time of the batched call and of the
    single-image calls, each replayed from a CUDA graph) and the least times
    of those calls."""
    from imageprocessingtools_tpu_torch.kernels import core, rotate
    from imageprocessingtools_tpu_torch.kernels import resize as k9
    from imageprocessingtools_tpu_torch.ops.histogram import _equalize_lut
    from imageprocessingtools_tpu_torch.ops.resize import resize_width, resize_width_batch
    from imageprocessingtools_tpu_torch.utils import graphs

    def resize_checked(x, target, what):
        """K9's two passes over the batch ``x``, each held to the plain batch
        pass and to the single-image kernel on each image."""
        out = x
        for dim, idx, w in k9.device_passes(x.shape[1], x.shape[2], target, dev):
            src, out = out, k9.resize_pass_batch(out, idx, w, dim)
            check("resize_pass_batch", out, k9.resize_pass_batch_plain(src, idx, w, dim),
                  f"{what} to {target}, dim {dim}")
            for i in range(src.shape[0]):
                check("resize_pass_batch", out[i], k9.resize_pass(src[i], idx, w, dim),
                      f"{what} to {target}, dim {dim}, image {i}")
        return out

    def resize_plain_batch(x, target):
        for dim, idx, w in k9.device_passes(x.shape[1], x.shape[2], target, dev):
            x = k9.resize_pass_batch_plain(x, idx, w, dim)
        return x

    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    batches = {}
    for n, h, w in BATCH_SHAPES:
        x = torch.randint(0, 256, (n, h, w, 3), generator=gen, device=dev, dtype=torch.uint8)
        batches[f"{n}x{h}x{w}"] = x
        if n > 1 and h < 1000:  # the flush between images: constant images among noise
            mixed = x.clone()
            mixed[::2] = (torch.arange(0, n, 2, device=dev) * 37 % 256).to(torch.uint8)[
                :, None, None, None]
            batches[f"{n}x{h}x{w} mixed"] = mixed
            batches[f"{n}x{h}x{w} at byte 5"] = at_byte(torch, x, 5)
    stencils = {f"{name}_batch": (getattr(core, f"{name}_batch"), getattr(core, name),
                                  getattr(core, f"{name}_batch_plain")) for name in STENCIL3}
    for what, x in batches.items():
        blurred, hist = core.gray_gauss_hist_batch(x)
        exp_blurred, exp_hist = core.gray_gauss_hist_batch_plain(x)
        check("gray_gauss_hist_batch", blurred, exp_blurred, f"{what} images")
        check("gray_gauss_hist_batch", hist, exp_hist, f"{what} histograms")
        check("gray_gauss_batch", core.gray_gauss_batch(x), exp_blurred, what)
        gray = at_byte(torch, blurred, 5) if what.endswith("at byte 5") else blurred
        luts = _equalize_lut(hist, gray.shape[1] * gray.shape[2])
        hists = core.histogram_batch(gray)
        check("histogram_batch", hists, core.histogram_batch_plain(gray), what)
        mapped = core.lut_apply_batch(gray, luts)
        check("lut_apply_batch", mapped, core.lut_apply_batch_plain(gray, luts), what)
        outs = {name: fn(gray) for name, (fn, _, _) in stencils.items()}
        for name, (_, _, plain) in stencils.items():
            check(name, outs[name], plain(gray), what)
        for angle in (30.0, 135.0):
            rotated = rotate.rotate_bicubic_batch(x, angle)
            check("rotate_batch", rotated, rotate.rotate_batch_plain(x, angle), f"{what} at {angle}")
            for i in range(x.shape[0]):
                check("rotate_batch", rotated[i], rotate.rotate_bicubic(x[i], angle),
                      f"{what} at {angle}, image {i}")
        resize_checked(x, x.shape[2] // 2 + 1, what)
        for i in range(x.shape[0]):  # the single-image kernels, image by image
            one_blurred, one_hist = core.gray_gauss_hist(x[i])
            check("gray_gauss_hist_batch", blurred[i], one_blurred, f"{what} image {i}")
            check("gray_gauss_hist_batch", hist[i], one_hist, f"{what} histogram {i}")
            check("histogram_batch", hists[i], core.histogram(gray[i]), f"{what} image {i}")
            check("lut_apply_batch", mapped[i], core.lut_apply(gray[i], luts[i]),
                  f"{what} image {i}")
            for name, (_, single, _) in stencils.items():
                check(name, outs[name][i], single(gray[i]), f"{what} image {i}")
    x = batches[f"{BATCH_N}x{H4K}x{W4K}"]
    check("fused_elementwise", core.fused_elementwise(x), core.fused_elementwise_plain(x),
          f"uint8[{BATCH_N}, {H4K}, {W4K}, 3]")
    # K9 at the main paths' geometries: 4K -> 1920 and -> 256 (thumbnail),
    # 1080p -> 3840, RGB and gray.
    x1080 = torch.randint(0, 256, (2, 1080, 1920, 3), generator=gen, device=dev,
                          dtype=torch.uint8)
    for src, target, what in ((x, 1920, "4K x 4"), (x, 256, "4K x 4"),
                              (x1080, 3840, "1080p x 2")):
        resize_checked(src, target, what)
        resize_checked(src[..., 1].contiguous(), target, f"{what} gray")
    del x1080
    blurred, hist = core.gray_gauss_hist_batch(x)
    luts = _equalize_lut(hist, H4K * W4K)
    rows = range(BATCH_N)

    def each(fn, *args):  # the single-image kernel on each image in turn
        return lambda: [fn(*(a[i] for a in args)) for i in rows]

    calls = {
        "gray_gauss_hist_batch": (lambda: core.gray_gauss_hist_batch(x),
                                  lambda: core.gray_gauss_hist_batch_plain(x),
                                  each(core.gray_gauss_hist, x)),
        "gray_gauss_batch": (lambda: core.gray_gauss_batch(x),
                             lambda: core.gray_gauss_batch_plain(x), each(core.gray_gauss, x)),
        "histogram_batch": (lambda: core.histogram_batch(blurred),
                            lambda: core.histogram_batch_plain(blurred),
                            each(core.histogram, blurred)),
        "lut_apply_batch": (lambda: core.lut_apply_batch(blurred, luts),
                            lambda: core.lut_apply_batch_plain(blurred, luts),
                            each(core.lut_apply, blurred, luts)),
        **{name: (lambda fn=fn: fn(blurred), lambda plain=plain: plain(blurred),
                  each(single, blurred))
           for name, (fn, single, plain) in stencils.items()},
        "rotate_batch": (lambda: rotate.rotate_bicubic_batch(x, 30.0),
                         lambda: rotate.rotate_batch_plain(x, 30.0),
                         each(lambda im: rotate.rotate_bicubic(im, 30.0), x)),
        # K9 through resize_width_batch: two launches, as the single entry's
        # times are resize_width's.
        "resize_pass_batch": (lambda: resize_width_batch(x, 1920),
                              lambda: resize_plain_batch(x, 1920),
                              each(lambda im: resize_width(im, 1920), x)),
        "resize_pass_batch_4k_to_256": (lambda: resize_width_batch(x, 256),
                                        lambda: resize_plain_batch(x, 256),
                                        each(lambda im: resize_width(im, 256), x)),
    }
    slow_plain = {"rotate_batch": 2}  # its plain batch takes 0.3 s a call: 2 calls a run
    times = {name: (median_ms(torch, a),
                    median_ms(torch, b, repeats=3, reps=slow_plain.get(name, REPS)),
                    median_ms(torch, c))
             for name, (a, b, c) in calls.items()}
    # The card's time of the batched call and of the single-image calls on
    # each image, each captured into a CUDA graph and replayed (no host
    # launches between them).
    device_times = {name: tuple(median_ms(torch, graphs.capture(lambda _, fn=fn: fn(), x).replay)
                                for fn in (a, c))
                    for name, (a, _, c) in calls.items()}
    px = BATCH_N * H4K * W4K
    bounds = {
        "gray_gauss_hist_batch": bound(4 * px + BATCH_N * 256 * 4, (GRAY_OPS + GAUSS_OPS + 1) * px),
        "gray_gauss_batch": bound(4 * px, (GRAY_OPS + GAUSS_OPS) * px),
        "histogram_batch": bound(px + BATCH_N * 256 * 4, px),
        "lut_apply_batch": bound(2 * px + BATCH_N * 256, 0),
        "stencil3_batch": bound(2 * px, SOBEL_OPS * px),
        # K1 and K9: BATCH_N times the single image's bytes and operations.
        "rotate_batch": bound(*(BATCH_N * v for v in rotate_cost(torch, rotate, x[0], 30.0)),
                              F64_UNFUSED_OPS_PER_MS),
        **{name: bound(*(BATCH_N * v for v in resize_cost(
            k9.device_passes(H4K, W4K, target, dev), (H4K, W4K, 3))), F64_UNFUSED_OPS_PER_MS)
           for name, target in (("resize_pass_batch", 1920),
                                ("resize_pass_batch_4k_to_256", 256))},
    }
    line = (f"phase 3 batch axis: the batched kernels byte-equal to their plain batch versions "
            f"and to the single-image kernels image by image on {', '.join(batches)} (K1 at 30 "
            f"and 135 degrees, K9 to half the width plus one); K9 at 4K x 4 to 1920 and 256 and "
            f"at 1080p x 2 to 3840, RGB and gray; K8 on "
            f"uint8[{BATCH_N}, {H4K}, {W4K}, 3]; ms per call on uint8[{BATCH_N}, {H4K}, {W4K}"
            f"(, 3)] (batched / plain batch / the single-image kernel on each image) on {card}: "
            + ", ".join(f"{k} {a:.4f} / {b:.4f} / {c:.4f}" for k, (a, b, c) in times.items())
            + "; the card's ms per call (each call a CUDA graph, replayed; batched / the "
            "single-image kernel on each image): "
            + ", ".join(f"{k} {a:.4f} / {b:.4f}" for k, (a, b) in device_times.items())
            + "; least ms: " + ", ".join(f"{k} {b:.4f} ({by})" for k, (b, by) in bounds.items()))
    return line, {k: times[k] + device_times[k] for k in times}, bounds


# The batch forms against the per-image graphs: (task, images, H, W).
BATCH_FORM_CASES = [("mega", 10, H4K, W4K), ("mega", 8, 1080, 1920), ("mega", 16, 768, 1366),
                    ("mega", 64, 512, 512)] + [
    (name, n, h, w) for name in ("edge_detect", "enhance", "print_ready", "thumbnail", "-r30")
    for n, h, w in ((8, H4K, W4K), (64, 512, 512))] + [
    (name, 8, H4K, W4K) for name in ("-w1920", "-w1920 -r30 -gray",
                                     "fanout -w1920;-r30;-gray;-mono -fh")] + [
    ("-mono -fh", 64, 512, 512)]
# Reference configs of those cases, as PipelineConfig keywords.
FORM_CONFIGS = {"-w1920": dict(new_width=1920), "-r30": dict(angle=30.0),
                "-gray": dict(gray=True), "-mono -fh": dict(mono=True, flip_h=True),
                "-w1920 -r30 -gray": dict(new_width=1920, angle=30.0, gray=True)}
# Each task's launches: the batch form's per group, the per-image graph's per
# image (a resize is two K9 launches; -mono -fh runs no kernel).
FORM_LAUNCHES = {
    "mega": ({"gray_gauss_hist_batch": 1, "lut_apply_batch": 1},
             {"gray_gauss_hist": 1, "lut_apply": 1}),
    "edge_detect": ({"gray_gauss_batch": 1, "sobel_batch": 1}, {"gray_gauss": 1, "sobel": 1}),
    "enhance": ({"fused_elementwise": 1, "histogram_batch": 1, "lut_apply_batch": 1,
                 "sharpen_batch": 1},
                {"fused_elementwise": 1, "histogram": 1, "lut_apply": 1, "sharpen": 1}),
    "print_ready": ({"fused_elementwise": 1, "histogram_batch": 1, "lut_apply_batch": 1,
                     "dither_pack_batch": 1},
                    {"fused_elementwise": 1, "histogram": 1, "lut_apply": 1,
                     "dither_pack_batch": 1}),
    "thumbnail": ({"resize_pass_batch": 2}, {"resize_pass": 2}),
    "-w1920": ({"resize_pass_batch": 2}, {"resize_pass": 2}),
    "-r30": ({"rotate_bicubic_batch": 1}, {"rotate_bicubic": 1}),
    "-w1920 -r30 -gray": ({"resize_pass_batch": 2, "rotate_bicubic_batch": 1,
                           "fused_elementwise": 1},
                          {"resize_pass": 2, "rotate_bicubic": 1, "fused_elementwise": 1}),
    "fanout -w1920;-r30;-gray;-mono -fh": (
        {"resize_pass_batch": 2, "rotate_bicubic_batch": 1, "fused_elementwise": 1},
        {"resize_pass": 2, "rotate_bicubic": 1, "fused_elementwise": 1}),
    "-mono -fh": ({}, {}),
}


def batch_form_times(torch, dev, card) -> str:
    """Each of ``BATCH_FORM_CASES`` as one group through ``graphs.batched``
    twice: the function with its batch form (each kernel launched once over
    the group) and the same body with none (the per-image graph), byte-equal;
    ms per group (the input on the card copied into the graph, one replay,
    the outputs copied out) and the replay alone per image (the graph's
    device time: CUDA events around 20 replays, its input already in it),
    with each graph's launches per replay (``FORM_LAUNCHES``: each kernel
    once per group in the batch form's, once per image in the other, a
    resize twice, or the run fails). The graphs are dropped after each
    case."""
    from imageprocessingtools_tpu_torch import serving
    from imageprocessingtools_tpu_torch.kernels import fused
    from imageprocessingtools_tpu_torch.pipeline import PipelineConfig
    from imageprocessingtools_tpu_torch.utils import graphs

    card0 = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)

    def task(name):
        if name.startswith("fanout "):
            return tuple(PipelineConfig(**FORM_CONFIGS[f]) for f in name[7:].split(";"))
        return PipelineConfig(**FORM_CONFIGS[name]) if name in FORM_CONFIGS else name

    forms = {"mega": fused.fused_pipeline_mega}
    forms.update({name: serving._task_fn(task(name))[0] for name, *_ in BATCH_FORM_CASES
                  if name != "mega"})

    def without(fn):
        def each(img):  # the same body, with no batch form
            return fn(img)
        return each

    bodies = {name: (fn, without(fn)) for name, fn in forms.items()}
    parts = []
    for name, n, h, w in BATCH_FORM_CASES:
        if graphs.group_size(h * w * 3) < n:
            fail(f"{name} {n}x{h}x{w} is not one group")
        x = torch.randint(0, 256, (n, h, w, 3), generator=gen, device=dev, dtype=torch.uint8)
        outs, cols = [], []
        for fn, per_replay in zip(bodies[name], (
                FORM_LAUNCHES[name][0],  # per group
                {k: n * v for k, v in FORM_LAUNCHES[name][1].items()})):  # per image
            run = graphs.batched(fn)
            outs.append(run(x, dev))
            key = (fn, card0, (h, w, 3), torch.uint8, n)
            entry = graphs._batch_graphs[key]
            group_ms = median_ms(torch, lambda: run(x, dev), repeats=3)
            replay_ms = median_ms(torch, entry.captured.replay, repeats=3)
            made = {wr.__name__: k for wr, k in entry.captured.launches.items() if k}
            cols.append(f"{group_ms:.4f} ms, the replay alone {replay_ms:.4f} ms = "
                        f"{replay_ms * 1e3 / n:.2f} us an image, launches {made}")
            if made != per_replay:
                fail(f"{name} {n}x{h}x{w}: a replay launches {made}, not {per_replay}")
            del entry
            graphs._batch_graphs.pop(key)
        for a, b in zip(*(o if isinstance(o, tuple) else (o,) for o in outs)):
            if not torch.equal(a, b):
                fail(f"{name} on {n}x{h}x{w}: the batch form differs from the per-image graph")
        parts.append(f"{name} {n}x{h}x{w}: batch form {cols[0]}; per image {cols[1]}")
        del x, outs
    return (f"phase 6 batch forms against the per-image graphs, one group each, byte-equal (ms "
            f"per group, input on the card, and the replay alone: device us per image, CUDA "
            f"events around {REPS} replays, median of 3) on {card}: " + "; ".join(parts))


def joins_us(split: dict) -> float:
    """The device us of a trace's window joins (``torch.cat``'s kernels)."""
    return sum(us for name, us in split.items() if "Cat" in name)


def phase_7(torch, dev, card, drive, path_counts, serve_run, serve_walls, files, bad,
            fanout_flags, n_good, plain_presets, trace_dir) -> tuple[list[str], tuple, tuple]:
    """Spatial and mesh: the band paths on a mesh that names the card four
    times (compiled: one CUDA graph each), the compiled band forms against
    the eager ones in 1 and 4 bands, their device us and joins, a giant
    image, then ``serve --mesh`` and ``serve --spatial`` (twice) over phase
    6's files. Returns the lines to print, and the traces (device us per
    call, events) of the flagship mega, eager and compiled."""
    from imageprocessingtools_tpu_torch import parallel
    from imageprocessingtools_tpu_torch.kernels import core, fused
    from imageprocessingtools_tpu_torch.models import PRESETS as PRESET_FNS
    from imageprocessingtools_tpu_torch.parallel import spatial
    from imageprocessingtools_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from imageprocessingtools_tpu_torch.profile_device import device_split, device_us_per_call
    from imageprocessingtools_tpu_torch.utils import graphs

    card0 = torch.device("cuda", torch.cuda.current_device())
    mesh4 = (card0,) * 4
    configs = {k: PipelineConfig(**v) for k, v in SPATIAL_CONFIGS.items()}
    labels = ["fused", *PRESETS.split(","), *configs]

    def banded(label, src, mesh):
        """The band form through the public functions: compiled for an
        image on a one-card mesh, eager for bands."""
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
    captures = graphs.captures_made
    # Four bands each, one graph each (its warm-up and one replay): fused K6,
    # K4, K3; edge_detect K6, Sobel; enhance K8, K4, K3, sharpen; print_ready
    # K8, K4, K3; thumbnail, -w1920 and -w1920 -r30 two K9 passes of four
    # launches; -r30 K1 in its band form, four launches, and four more.
    path_counts["spatial"] = drive(
        "phase 7 spatial",
        {"gray_gauss": 8, "sobel": 4, "sharpen": 4, "fused_elementwise": 8, "histogram": 12,
         "lut_apply": 12, "resize_pass": 24, "rotate": 8},
        lambda: outs.update({label: banded(label, host, mesh4) for label in labels}))
    if graphs.captures_made - captures != len(labels):
        fail(f"phase 7 spatial captured {graphs.captures_made - captures} graphs, not one per "
             f"band path ({len(labels)})")
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
        if label in configs and label not in PLAIN_CONFIGS:
            continue
        with ipt_device("cpu"):
            plain = unsharded(label, torch.from_numpy(host))
        if not torch.equal(got.cpu(), plain):
            fail(f"spatial {label} differs from the plain path on the cpu")
    n_bands = {label: len(outs[label]) for label in labels}
    del outs
    lines = [f"phase 7 spatial: {', '.join(labels)} on {H4K}x{W4K} in bands {n_bands} over a mesh "
             f"of the card x4, one CUDA graph each, byte-equal to the unsharded path on the card "
             f"and (all but {', '.join(c for c in configs if c not in PLAIN_CONFIGS)}) to the "
             f"plain path on the cpu"]

    # The compiled band forms against the eager ones (the bands given as
    # views of the input on the card) in 1 and 4 bands, byte-equal to each
    # other and to the unsharded path; ms per call of both.
    form_ms = {}
    for n in (1, 4):
        mesh = (card0,) * n
        for label in labels:
            def compiled(label=label, mesh=mesh):
                return banded(label, src, mesh)

            def eager(label=label, mesh=mesh):
                return banded(label, spatial.shard_rows(src, mesh), mesh)

            c, e = (spatial.gather(f(), card0) for f in (compiled, eager))
            if not (torch.equal(c, e) and torch.equal(c, expected[label])):
                fail(f"spatial {label} in {n} bands: compiled, eager and unsharded differ "
                     f"({max_abs_err(torch, c, e)}, {max_abs_err(torch, c, expected[label])})")
            del c, e
            task = configs.get(label, label)
            entry = spatial._band_graphs[spatial.graph_key(task, src.shape, src.dtype, mesh)]
            form_ms[label, n] = (median_ms(torch, eager), median_ms(torch, compiled),
                                 median_ms(torch, entry.captured.replay))
    lines.append(f"phase 7 band forms, ms per call eager / compiled / the replay alone (CUDA "
                 f"events around {REPS} calls, median of 5, input on the card; compiled: the "
                 f"copy-in and the outputs' clone included) in 1 and 4 bands, {H4K}x{W4K} on "
                 f"{card}, compiled and eager byte-equal to each other and to the unsharded "
                 f"path: " + "; ".join(
                     f"{label} " + ", ".join(f"{n} " + " / ".join(
                         f"{t:.4f}" for t in form_ms[label, n]) for n in (1, 4))
                     for label in labels))

    # The run's only traces, taken within seconds of each other: a trace
    # taken long after the process's first one loses device events at its
    # start. Four bands: eager (the bands views of one input), compiled, and
    # eager over bands that are separate copies (each window then joined by
    # torch.cat, as before bands were views); the unsharded form beside
    # them. The unsharded fused pipeline is the flagship mega: it is traced
    # with utils.profiling (trace_to, a span).
    timed = {"fused": lambda: fused.fused_pipeline_mega(src),
             "edge_detect": lambda: core.sobel(core.gray_gauss(src))}
    copies = [spatial.Band(b.row0, b.data.clone()) for b in spatial.shard_rows(src, mesh4)]
    parts = []
    for label, one_fn in timed.items():
        # A trace that still lost events after profile_device's retries stops the run.
        split = {
            "eager": device_split(f"spatial {label} eager",
                                  lambda: banded(label, spatial.shard_rows(src, mesh4), mesh4)),
            "compiled": device_split(f"spatial {label} compiled",
                                     lambda: banded(label, src, mesh4)),
            "copies": device_split(f"spatial {label} eager over copies",
                                   lambda: banded(label, copies, mesh4)),
        }
        if label == "fused":
            mega_trace = traced_us(torch, "chip_smoke: flagship mega", one_fn, REPS, trace_dir)
            graph_trace = traced_us(torch, "chip_smoke: flagship mega compiled",
                                    lambda: fused.fused_gray_gauss_histeq_pallas_mega(src),
                                    REPS, trace_dir)
            one_us = mega_trace[0]
        else:
            one_us = device_us_per_call(label, one_fn)
        us = {form: sum(s.values()) for form, s in split.items()}
        more = {name[:40]: t - split["eager"].get(name, 0.0) for name, t in
                split["compiled"].items() if t - split["eager"].get(name, 0.0) > 0.5}
        parts.append(f"{label} device us eager {us['eager']:.2f} (joins "
                     f"{joins_us(split['eager']):.2f}), compiled {us['compiled']:.2f} (joins "
                     f"{joins_us(split['compiled']):.2f}; more than eager: " + ", ".join(
                         f"{name} {t:.2f}" for name, t in sorted(more.items(),
                                                                 key=lambda kv: -kv[1]))
                     + f"), eager over separate copies {us['copies']:.2f} (joins "
                     f"{joins_us(split['copies']):.2f}), unsharded {one_us:.2f}")
    del copies
    lines.append(f"phase 7 times, 4 bands, {H4K}x{W4K} on {card} (profile_device, {REPS} calls): "
                 + "; ".join(parts))
    kept = [k for k in graphs.held() if k["fn"].startswith("spatial ")]
    lines.append(f"phase 7 band graphs on {card}: {graphs.captures_made - captures} captured, "
                 f"{len(kept)} kept: " + ", ".join(
                     f"{k['fn']} {'x'.join(map(str, k['input']))} {k['bytes']} B in "
                     f"{k['capture_s']:.3f} s" for k in kept))
    del src

    # One giant image: fused and edge_detect compiled in 4 bands against the
    # unsharded compiled path on the card; serve --spatial's fan-out of the
    # four presets (P4 packed) in one band against its eager band form.
    giant = torch.from_numpy(image(GIANT, seed=82)).to(dev)
    edge_graphed = graphs.graphed(PRESET_FNS["edge_detect"])
    giant_parts = []
    for label, one_fn in (("fused", fused.fused_gray_gauss_histeq_pallas_mega),
                          ("edge_detect", edge_graphed)):
        got = spatial.gather(banded(label, giant, mesh4), card0)
        band_entry = spatial._band_graphs[spatial.graph_key(label, GIANT, torch.uint8, mesh4)]
        want = one_fn(giant)
        one_entry = one_fn._graphs[graphs.graph_key(giant)]
        if not torch.equal(got, want):
            fail(f"giant {label} in 4 bands differs from the unsharded compiled path by "
                 f"{max_abs_err(torch, got, want)}")
        del got, want
        ms = (median_ms(torch, lambda: banded(label, giant, mesh4), repeats=3),
              median_ms(torch, lambda: one_fn(giant), repeats=3))
        giant_parts.append(f"{label} ms per call 4 bands {ms[0]:.4f} / unsharded {ms[1]:.4f}, "
                           f"graph bytes {band_entry.nbytes} / {one_entry.nbytes}, captured in "
                           f"{band_entry.seconds:.3f} / {one_entry.seconds:.3f} s")
    del edge_graphed
    fan = tuple(PRESETS.split(","))
    pack = tuple(name == "print_ready" for name in fan)
    with spatial.band_outputs(fan, giant, (card0,), pack) as (got, _):
        got = [spatial.gather(bands, card0) for bands in got]
    fan_entry = spatial._band_graphs[spatial.graph_key(fan, GIANT, torch.uint8, (card0,), pack)]
    n_kept = len(graphs.held())
    if fan_entry.nbytes > graphs.GRAPH_BYTES_BOUND and n_kept != 1:
        fail(f"a graph of {fan_entry.nbytes} bytes, above the bound, is kept beside {n_kept - 1}")
    with spatial.band_outputs(fan, spatial.shard_rows(giant, (card0,)), (card0,), pack) as (
            eager, _):
        for name, g, bands in zip(fan, got, eager):
            if not torch.equal(g, spatial.gather(bands, card0)):
                fail(f"giant serve --spatial fan-out: {name} differs from the eager band form")
    del got, eager, giant
    torch.cuda.empty_cache()
    lines.append(f"phase 7 giant uint8[{', '.join(map(str, GIANT))}] on {card}, byte-equal, "
                 f"compiled (CUDA events around {REPS} calls, median of 3, input on the card): "
                 + "; ".join(giant_parts) + f"; serve --spatial's fan-out of the presets in one "
                 f"band (P4 packed) {fan_entry.nbytes} B captured in {fan_entry.seconds:.3f} s, "
                 f"graphs kept with it {n_kept - 1}, byte-equal to its eager band form")

    # serve --mesh and serve --spatial over phase 6's files (one band and one
    # shard per card), byte-equal to phase 6's outputs; then serve --spatial
    # again in the same process, which replays the graphs of the first.
    def moved_serving():
        for mode in ("--mesh", "--spatial"):
            sfx = "." + mode[2:]
            serve_run(f"{mode} presets",
                      [mode, "--preset", PRESETS, "--skip-bad", "--suffix", sfx, *files, bad])
            serve_run(f"{mode} fanout", [mode, "--fanout", fanout_flags, "--suffix", sfx,
                                         *files[:8]])

    # --mesh (a batch of shards, one card here) as phase 6: the batch forms
    # once per group; --spatial one band per file on one card, the tasks'
    # single-image kernels once per file.
    path_counts["serving moved"] = drive(
        "phase 7 serving",
        {"gray_gauss": n_good, "sobel": n_good, "sharpen": n_good,
         "fused_elementwise": (2 * n_good + 8) + (4 + 1), "histogram": 2 * n_good,
         "lut_apply": 2 * n_good, "gray_gauss_batch": 2, "sobel_batch": 2, "sharpen_batch": 2,
         "histogram_batch": 4, "lut_apply_batch": 4, "dither_pack_batch": 2, "rotate": 8,
         "rotate_batch": 1,
         "resize_pass": 2 * n_good + 2 * 8, "resize_pass_batch": 2 * 2 + 2},
        moved_serving)
    captures = graphs.captures_made
    serve_run("--spatial presets again",
              ["--spatial", "--preset", PRESETS, "--skip-bad", "--suffix", ".again", *files, bad])
    serve_run("--spatial fanout again",
              ["--spatial", "--fanout", fanout_flags, "--suffix", ".again", *files[:8]])
    if graphs.captures_made != captures:
        fail(f"the second serve --spatial captured {graphs.captures_made - captures} graphs")
    n_equal = 0
    for i, path in enumerate(files):
        for tag in list(plain_presets)[:4] + (["gray", "w1920-r30"] if i < 8 else []):
            with open(f"{path}.{tag}.out", "rb") as f:
                want = f.read()
            for mode in ("mesh", "spatial", "again"):
                with open(f"{path}.{tag}.{mode}", "rb") as f:
                    if f.read() != want:
                        fail(f"serve --{mode} {path}.{tag} differs from phase 6's output")
                n_equal += 1
    for sfx in ("spatial", "again"):
        if os.path.exists(f"{bad}.edge_detect.{sfx}"):
            fail("serve --spatial wrote an output for the truncated file")
    kept = graphs.held()
    total = sum(k["bytes"] for k in kept)
    if total > graphs.GRAPH_BYTES_BOUND and len(kept) > 1:
        fail(f"{len(kept)} graphs hold {total} bytes, above the bound "
             f"{graphs.GRAPH_BYTES_BOUND}")
    served = [k for k in kept if k["fn"].startswith("spatial ") and k["input"][0] in (H4K, 1080)
              and k["fn"].count(";")]
    lines.append(f"phase 7 serving: --mesh, --spatial and --spatial again wrote {n_equal} "
                 f"outputs byte-equal to phase 6's; the second --spatial captured nothing; "
                 f"graphs kept {len(kept)}, {total} bytes of the bound's "
                 f"{graphs.GRAPH_BYTES_BOUND}, --spatial's: " + ", ".join(
                     f"{k['fn']} {'x'.join(map(str, k['input']))} {k['bytes']} B in "
                     f"{k['capture_s']:.3f} s" for k in served)
                 + f"; wall on {card}: " + ", ".join(
                     f"{label} {wall:.3f} s" for label, (wall, _) in serve_walls.items()
                     if label.startswith("--")))

    # Every card torch sees, where there are several: the eager band paths.
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
    return lines, mega_trace, graph_trace


def traced_us(torch, label: str, fn, reps: int, trace_dir: str) -> tuple[float, int]:
    """(device us per call of ``fn``, device events): ``reps`` calls traced by
    ``utils.profiling.trace_to`` inside a ``span(label)``, their
    device events (``profile_device.device_events``) summed over ``reps``.
    The trace file must hold the span, and ``reps`` times the events of
    one traced call (``profile_device.lost_events``); a trace without device
    events or with lost ones is taken again, up to ``profile_device.ATTEMPTS``
    times, and then the run fails. ``fn``'s outputs are not kept."""
    from imageprocessingtools_tpu_torch.profile_device import ATTEMPTS, device_events, lost_events
    from imageprocessingtools_tpu_torch.utils.profiling import span, trace_to

    fn()  # warm-up: the first launches
    torch.cuda.synchronize()
    problem = "no attempt"
    for _ in range(ATTEMPTS):
        with trace_to(trace_dir) as one:
            fn()
        with trace_to(trace_dir) as prof:
            with span(label):
                for _ in range(reps):
                    fn()
        with open(prof.chrome_trace) as f:
            trace = json.load(f)
        trace = trace["traceEvents"] if isinstance(trace, dict) else trace
        if not any(e.get("name") == label and e.get("cat") == "ipt_span" for e in trace):
            fail(f"the trace of {label!r} ({prof.chrome_trace}) does not hold its span")
        try:
            per_call = collections.Counter(e["name"] for e in device_events(one))
            events = device_events(prof)
        except RuntimeError as e:  # the tracer returned no device event
            problem = str(e)
        else:
            lost = lost_events(events, per_call, reps)
            if not lost:
                return sum(e["dur"] for e in events) / reps, len(events)
            problem = f"lost events (name: [found, wanted]): {json.dumps(lost)}"
        time.sleep(0.5)
    fail(f"the trace of {label!r} after {ATTEMPTS} attempts: {problem}")


# Phase 8: images of 2^31 bytes and more, made on the card. uint8[27000,
# 27000, 3] is 2,187,000,000 bytes; uint8[46341, 46341] 2,147,488,281. Each
# kernel's last BOTTOM output rows are held to the plain version on the
# bottom window with its halo: rows whose input (and for K1 output) offsets
# pass 2^31; on the gray image the last row's tail passes it. K1's bottom
# rows hold the source's corner only, so a band of BOTTOM rows at three
# quarters of its output, past 2^31 in both, is checked too.
BIG_RGB, BIG_GRAY, BOTTOM = (27000, 27000, 3), (46341, 46341), 64


def phase_8(torch, dev, card) -> tuple[list[str], dict]:
    """K1 (30 degrees), K2 and K6 on the RGB image, K5 and K7 (Sobel) on the
    gray one. Returns the lines to print and, per kernel, its input shape,
    the output rows and the byte ranges checked, its error and device us."""
    from imageprocessingtools_tpu_torch.kernels import core, rotate

    gen = torch.Generator(device=dev)
    gen.manual_seed(2**31)
    results = {}

    def check(name, src, out, bands, fn, least):
        """Hold each band (row0, row1, exp, (lo, hi)) of ``out`` to ``exp``,
        which the plain version made from the source rows [lo, hi); then
        time ``fn`` (CUDA events, ``median_ms``: at these sizes the card's
        time, the launch is a few us of it) beside its ``least`` time."""
        out_row, src_row = out[0].numel(), src[0].numel()
        entry = {"input": list(src.shape), "output": list(out.shape), "max_abs_err": 0,
                 "output_bytes_checked": [], "input_bytes_read": [],
                 "bound_us": least[0] * 1e3, "bound_by": least[1]}
        for row0, row1, exp, (lo, hi) in bands:
            err = max_abs_err(torch, out[row0:row1], exp)
            if err:
                fail(f"phase 8 {name} rows [{row0}, {row1}) differ from plain by {err}")
            entry["output_bytes_checked"].append([row0 * out_row, row1 * out_row])
            entry["input_bytes_read"].append([lo * src_row, hi * src_row])
        entry["device_us"] = median_ms(torch, fn, repeats=3) * 1e3
        results[name] = entry

    big = torch.randint(0, 256, BIG_RGB, dtype=torch.uint8, device=dev, generator=gen)
    h, w, _ = BIG_RGB
    out = rotate.rotate_bicubic(big, 30.0)
    bands = []
    for row0 in (out.shape[0] * 3 // 4 // rotate.TILE * rotate.TILE,
                 (out.shape[0] - BOTTOM) // rotate.TILE * rotate.TILE):
        row1 = min(row0 + BOTTOM, out.shape[0])
        lo, hi = rotate.band_window(h, w, 30.0, row0, row1)
        bands.append((row0, row1, rotate.rotate_plain(
            big[lo:hi], 30.0, height=h, src_row0=lo, out_rows=(row0, row1)), (lo, hi)))
    check("rotate", big, out, bands, lambda: rotate.rotate_bicubic(big, 30.0),
          bound(*rotate_cost(torch, rotate, big, 30.0), F64_UNFUSED_OPS_PER_MS))
    del out, bands

    gray, hist = core.gray_gauss_hist(big)
    exp = core.gray_gauss_plain(big[h - BOTTOM - 2:])[2:]
    bottom = [(h - BOTTOM, h, exp, (h - BOTTOM - 2, h))]
    px = h * w
    check("gray_gauss_hist", big, gray, bottom, lambda: core.gray_gauss_hist(big),
          bound(4 * px + 256 * 4, (GRAY_OPS + GAUSS_OPS + 1) * px))
    count = torch.bincount(gray.reshape(-1), minlength=256).to(torch.int32)
    if not torch.equal(hist, count):
        fail(f"phase 8 gray_gauss_hist's histogram differs from torch.bincount by "
             f"{int((hist - count).abs().max())}")
    out = core.gray_gauss(big)
    check("gray_gauss", big, out, bottom, lambda: core.gray_gauss(big),
          bound(4 * px, (GRAY_OPS + GAUSS_OPS) * px))
    if not torch.equal(out, gray):
        fail("phase 8 gray_gauss differs from gray_gauss_hist's image")
    del big, gray, out, exp, bottom

    g = torch.randint(0, 256, BIG_GRAY, dtype=torch.uint8, device=dev, generator=gen)
    h, px = BIG_GRAY[0], g.numel()
    check("gaussian_blur", g, core.gaussian_blur(g),
          [(h - BOTTOM, h, core.gaussian_blur_plain(g[h - BOTTOM - 2:])[2:], (h - BOTTOM - 2, h))],
          lambda: core.gaussian_blur(g), bound(2 * px, GAUSS_OPS * px))
    check("sobel", g, core.sobel(g),
          [(h - BOTTOM, h, core.sobel_plain(g[h - BOTTOM - 1:])[1:], (h - BOTTOM - 1, h))],
          lambda: core.sobel(g), bound(2 * px, SOBEL_OPS * px))
    del g
    torch.cuda.empty_cache()
    line = (f"phase 8 large images on {card}: output rows byte-equal to plain (output bytes "
            f"checked; input bytes read) — "
            + "; ".join(f"{k} {'x'.join(map(str, v['input']))} -> "
                        f"{'x'.join(map(str, v['output']))} {v['output_bytes_checked']}; "
                        f"{v['input_bytes_read']}" for k, v in results.items())
            + "; gray_gauss_hist's histogram equal to torch.bincount; device us per call "
            f"(CUDA events around {REPS} calls, median of 3): "
            + ", ".join(f"{k} {v['device_us']:.2f} (least {v['bound_us']:.2f}, {v['bound_by']})"
                        for k, v in results.items()))
    return [line], results


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
    from imageprocessingtools_tpu_torch import cli, device, parallel, serve, serving
    from imageprocessingtools_tpu_torch.codec import native, ppm
    from imageprocessingtools_tpu_torch.kernels import _build, core, fused, rotate
    from imageprocessingtools_tpu_torch.kernels import resize as k9
    from imageprocessingtools_tpu_torch.ops import _exact
    from imageprocessingtools_tpu_torch.ops.color import grayscale
    from imageprocessingtools_tpu_torch.ops.dither import mono_dither
    from imageprocessingtools_tpu_torch.ops.histogram import _equalize_lut
    from imageprocessingtools_tpu_torch.ops.resize import resize, resize_width, resize_width_dense
    from imageprocessingtools_tpu_torch.pipeline import PipelineConfig
    from imageprocessingtools_tpu_torch.utils import device_loop_rate, dispatch_time, graphs

    dev = device.get_device()
    if dev.type != "cuda":
        fail(f"the configured device is {dev}, not cuda (is IPT_DEVICE set?)")
    dev_index = parallel.default_mesh((dev,))[0]  # the card, named with its index

    wrappers = {
        "rotate": rotate.rotate_bicubic, "gray_gauss_hist": core.gray_gauss_hist,
        "lut_apply": core.lut_apply, "histogram": core.histogram,
        "gaussian_blur": core.gaussian_blur, "gray_gauss": core.gray_gauss,
        "box_blur": core.box_blur, "sharpen": core.sharpen, "sobel": core.sobel,
        "fused_elementwise": core.fused_elementwise, "resize_pass": k9.resize_pass,
        **{name: getattr(core, name) for name in
           ("gray_gauss_hist_batch", "gray_gauss_batch", "histogram_batch", "lut_apply_batch")
           + STENCIL3_BATCH},
        "rotate_batch": rotate.rotate_bicubic_batch, "resize_pass_batch": k9.resize_pass_batch,
        "dither_pack_batch": core.dither_pack_batch,
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
    print(f"phase 2 build: {'built' if built else 'reused'} {lib_path}"
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
    batch_line, batch_times, batch_bounds = phase_3_batch(torch, dev, card, check)
    print(batch_line)
    dither_line, dither_entry = phase_3_dither_pack(torch, dev, card, check)
    print(dither_line)

    tmp = tempfile.mkdtemp(prefix="ipt_chip_smoke_")
    trace_dir = os.path.join(tmp, "traces")
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

        # Phase 5: the flagship at 4K, through K2 and K3, and staged through K8, K5, K4, K3;
        # eager, and compiled: the CUDA graphs that stand for the JAX package's jax.jit forms.
        flagship = torch.from_numpy(image((H4K, W4K, 3), seed=30)).to(dev)
        forms = {"mega": fused.fused_pipeline_mega, "staged": fused.fused_pipeline_staged}
        compiled = {"mega": fused.fused_gray_gauss_histeq_pallas_mega,
                    "staged": fused.fused_gray_gauss_histeq_pallas}
        # Two inputs in turn at 4K (the first is the flagship's) and at an odd
        # shape; all four outputs are checked after both calls.
        for shape, seeds in (((H4K, W4K, 3), (30, 32)), ((1081, 1927, 3), (33, 34))):
            xs = [torch.from_numpy(image(shape, seed=s)).to(dev) for s in seeds]
            want = [fused.fused_pipeline(x) for x in xs]
            for form, graph_fn in compiled.items():
                outs = [graph_fn(x) for x in xs]
                static = graph_fn._graphs[graphs.graph_key(xs[0])].captured.out
                for x, out, exp in zip(xs, outs, want):
                    if out.data_ptr() == static.data_ptr():
                        fail(f"compiled {form} returned the graph's own output buffer")
                    if not torch.equal(out, exp):
                        fail(f"compiled {form} {shape} differs from plain by "
                             f"{max_abs_err(torch, out, exp)} (the first of two inputs: "
                             f"{out is outs[0]})")
                    if not torch.equal(out, forms[form](x)):
                        fail(f"compiled {form} {shape} differs from the eager form")
        results = {}

        def flagships():
            for form in forms:
                results[form] = forms[form](flagship)
                results[f"compiled {form}"] = compiled[form](flagship)  # a replay

        path_counts["flagship"] = drive(
            "phase 5 flagship",
            {"gray_gauss_hist": 2, "lut_apply": 4, "fused_elementwise": 2, "gaussian_blur": 2,
             "histogram": 2},
            flagships)
        plain = fused.fused_pipeline(flagship)
        for form, out in results.items():
            if out.dtype != torch.uint8 or tuple(out.shape) != (H4K, W4K):
                fail(f"flagship {form} gave {out.dtype} {tuple(out.shape)}")
            if not torch.equal(out, plain):
                fail(f"flagship {form} differs from plain by {max_abs_err(torch, out, plain)}")
        flagship_ms = {form: median_ms(torch, lambda: fn(flagship)) for form, fn in
                       (*forms.items(), *((f"compiled {k}", v) for k, v in compiled.items()))}
        mega_entry = compiled["mega"]._graphs[graphs.graph_key(flagship)]
        copy_ms = median_ms(torch, lambda: (mega_entry.static_in.copy_(flagship),
                                            mega_entry.captured.out.clone()))
        plain_ms = median_ms(torch, lambda: fused.fused_pipeline(flagship))
        print(f"phase 5 flagship 2160x3840 mega and staged, eager and compiled (CUDA graphs), "
              f"byte-equal to plain, the compiled also to the eager at 2160x3840 and 1081x1927 "
              f"on two inputs in turn; ms per call "
              + ", ".join(f"{k} {v:.4f}" for k, v in flagship_ms.items())
              + f", plain {plain_ms:.3f}; mega {H4K * W4K / flagship_ms['mega'] / 1e3:.1f} "
              f"MPix/s, compiled {H4K * W4K / flagship_ms['compiled mega'] / 1e3:.1f}; a graph's "
              f"copy-in (24.9 MB) and clone (8.3 MB) {copy_ms:.4f} ms, on {card}")
        # The flagship's device time from utils/timing.py (a CUDA graph of the
        # loop; one replay); its traced device us come from phase 7's window
        # of traces.
        loop_ms = device_loop_rate(fused.fused_pipeline_mega, flagship, iters=REPS, repeats=5,
                                   stat="median") * 1e3
        dispatch_ms = dispatch_time(fused.fused_pipeline_mega, flagship) * 1e3

        # The batch module: four 4K images through the mega form's batch
        # form, captured in a first call, then one replay of the graph of the
        # four (G is 10 at 4K) with the counts at 0: K2 and K3 exactly once
        # each; each output byte-equal to the plain pipeline's and to the
        # eager loop's.
        batch_in = torch.from_numpy(image((4, H4K, W4K, 3), seed=31))
        captures = graphs.captures_made
        first_batch = parallel.batched_fused_pipeline(batch_in)  # captures the graph (and warms up)
        path_counts["batch"] = drive(  # one replay
            "phase 5 batch", {"gray_gauss_hist_batch": 1, "lut_apply_batch": 1},
            lambda: results.update(batch=parallel.batched_fused_pipeline(batch_in)))
        once = {name: path_counts["batch"][name] for name in
                ("gray_gauss_hist_batch", "lut_apply_batch", "gray_gauss_hist", "lut_apply")}
        if once != {"gray_gauss_hist_batch": 1, "lut_apply_batch": 1, "gray_gauss_hist": 0,
                    "lut_apply": 0}:
            fail(f"batched_fused_pipeline on four images did not launch K2 and K3 once each "
                 f"over the batch (launches {once})")
        batch_out = results.pop("batch")
        if not torch.equal(batch_out, first_batch):
            fail("batched_fused_pipeline's replay differs from its first call")
        del first_batch
        if batch_out.dtype != torch.uint8 or tuple(batch_out.shape) != (4, H4K, W4K):
            fail(f"batched_fused_pipeline gave {batch_out.dtype} {tuple(batch_out.shape)}")
        if batch_out.device.type != "cuda":
            fail(f"batched_fused_pipeline ran on {batch_out.device}")
        batch_graph = graphs._batch_graphs.get(
            (fused.fused_pipeline_mega, dev_index, (H4K, W4K, 3), torch.uint8, 4))
        if batch_graph is None or graphs.captures_made != captures + 1:
            fail("batched_fused_pipeline did not run as one captured graph of four images")
        eager_batch_out = graphs.eager_batch(fused.fused_pipeline_mega, batch_in.to(dev))
        if not torch.equal(batch_out, eager_batch_out):
            fail("batched_fused_pipeline differs from the eager loop")
        for i in range(4):
            if not torch.equal(batch_out[i], fused.fused_pipeline(batch_in[i].to(dev))):
                fail(f"batched_fused_pipeline image {i} differs from the plain pipeline")
        print(f"phase 5 batch: batched_fused_pipeline on uint8[4, 2160, 3840, 3] (one replay of a "
              f"captured 4-image graph, {batch_graph.nbytes} bytes, captured in "
              f"{batch_graph.seconds:.3f} s; its batch form: K2 and K3 launched once each, "
              f"{once}) byte-equal to the eager loop and to four plain pipelines")

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

        # Per group of images of one shape (the 4K files and the 1080p ones:
        # two), the presets' batch forms: edge_detect one K6 and one Sobel,
        # enhance one K8, one K4, one K3 and one sharpen, print_ready one K8,
        # one K4, one K3 and one K10, thumbnail two K9, each over the group; the
        # fan-out's (the 4K files: one group) one K8 (-gray), two K9 (-w1920)
        # and one K1.
        n_good = len(files)
        captures = graphs.captures_made
        path_counts["serving"] = drive(
            "phase 6 serving",
            {"gray_gauss_batch": 2, "sobel_batch": 2, "sharpen_batch": 2,
             "fused_elementwise": 4 + 1, "histogram_batch": 4, "lut_apply_batch": 4,
             "dither_pack_batch": 2, "rotate_batch": 1, "resize_pass_batch": 2 * 2 + 2},
            serving_runs)
        per_image = {name: path_counts["serving"][name] for name in
                     ("gray_gauss", "sobel", "sharpen", "histogram", "lut_apply", "rotate",
                      "resize_pass")}
        if any(per_image.values()):
            fail(f"phase 6 serving launched the tasks' kernels image by image: {per_image}")
        # Each preset graph's own record: every kernel of a batch form once per
        # replay (one group; K9 twice), none of them per image.
        presets_one = serving._task_fn(tuple(PRESETS.split(",")))[0]
        per_group = {"gray_gauss_batch": 1, "sobel_batch": 1, "sharpen_batch": 1,
                     "histogram_batch": 2, "lut_apply_batch": 2, "dither_pack_batch": 1,
                     "resize_pass_batch": 2}
        preset_graphs = [e for k, e in graphs._batch_graphs.items() if k[0] is presets_one]
        if len(preset_graphs) != 2:
            fail(f"serve --preset kept {len(preset_graphs)} graphs, not one per shape (2)")
        for entry in preset_graphs:
            made = {w.__name__: n for w, n in entry.captured.launches.items()}
            if ({name: made.get(name, 0) for name in per_group} != per_group
                    or any(made.get(name) for name in per_image)):
                fail(f"a serve --preset graph of {tuple(entry.static_in.shape)} launches "
                     f"{made} per replay, not the batch forms' kernels once each")
        if f"skipped {bad}: Error: unexpected end of file." not in serve_walls["presets"][1]:
            fail(f"serve did not report the truncated file: {serve_walls['presets'][1]}")
        serving_captures = graphs.captures_made - captures

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
        # The same decoded images through the eager loop (graphs.eager_batch),
        # the plain form of the graphs that serve replayed: per preset, and
        # the fan-out on the 4K files.
        decoded = [ppm.decode_ppm(open(path, "rb").read())[0] for path in files]
        fanout_task = tuple(PipelineConfig(**kw) for kw in (dict(gray=True),
                                                            dict(new_width=1920, angle=30.0)))
        tasks = {**{name: name for name in PRESETS.split(",")}, "fanout": fanout_task}
        eager_outs = {}  # (tag, file index) -> the eager loop's output, unpacked
        for label, task in tasks.items():
            one, file_type = serving._task_fn(task)
            for idx in (range(8), range(8, n_good)) if label != "fanout" else (range(8),):
                out = graphs.eager_batch(one, torch.from_numpy(
                    np.stack([decoded[i] for i in idx])).to(dev))
                for tag, o in zip((label,) if label != "fanout" else ("gray", "w1920-r30"),
                                  out if isinstance(out, tuple) else (out,)):
                    o = o.cpu().numpy()
                    if file_type == ppm.FILETYPE_PBM:
                        o = np.unpackbits(o, axis=-1)[..., :decoded[idx[0]].shape[1]]
                    for j, i in enumerate(idx):
                        eager_outs[tag, i] = o[j]
        n_checked = 0
        for i, path in enumerate(files):
            src = torch.from_numpy(decoded[i]).to(dev)
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
                if not np.array_equal(got, eager_outs[tag, i]):
                    fail(f"serve {path}.{tag} differs from the eager loop")
                n_checked += 1
        if os.path.exists(bad + ".edge_detect.out"):
            fail("serve wrote an output for the truncated file")
        del eager_outs

        # A chunk of eight 4K images per task, input on the card: the eager
        # loop against the graphs that serve captured (one replay, the input
        # copied into the graph and the outputs out of it), byte-equal; and
        # the replay alone (its input already in the graph).
        chunk = torch.from_numpy(np.stack(decoded[:8])).to(dev)
        chunk_ms = {}
        for label, task in tasks.items():
            one, _ = serving._task_fn(task)
            run = graphs.batched(one)
            eager, graphed = (x if isinstance(x, tuple) else (x,)
                              for x in (graphs.eager_batch(one, chunk), run(chunk, dev)))
            for e, g in zip(eager, graphed):
                if not torch.equal(e, g):
                    fail(f"the graphed {label} chunk differs from the eager loop")
            del eager, graphed
            entry = graphs._batch_graphs[(one, dev_index, (H4K, W4K, 3), torch.uint8, 8)]
            chunk_ms[label] = (median_ms(torch, lambda: graphs.eager_batch(one, chunk), repeats=3),
                               median_ms(torch, lambda: run(chunk, dev), repeats=3),
                               median_ms(torch, entry.captured.replay, repeats=3))
        del chunk
        kept = graphs.held()
        graph_line = (
            f"phase 6 graphs: G {graphs.group_size(H4K * W4K * 3)} at 4K and "
            f"{graphs.group_size(1080 * 1920 * 3)} at 1080p; the serving drive captured "
            f"{serving_captures}; {len(kept)} kept, {sum(k['bytes'] for k in kept)} bytes of the "
            f"bound's {graphs.GRAPH_BYTES_BOUND}: " + ", ".join(
                f"{k['fn']} {'x'.join(map(str, k['input']))} {k['bytes']} B captured in "
                f"{k['capture_s']:.3f} s" for k in kept))
        chunk_line = (f"phase 6 ms per chunk of eight 4K images, input on the card (eager loop / "
                      f"graphed / the replay alone, CUDA events around {REPS} calls, median of 3) "
                      f"on {card}: " + ", ".join(f"{k} {a:.4f} / {b:.4f} / {c:.4f}"
                                                 for k, (a, b, c) in chunk_ms.items()))
        form_line = batch_form_times(torch, dev, card)

        # serve's sequential split (no reader or writer thread), host seconds
        # per stage, each synchronised, in three turns; then the overlapped
        # serves' walls (reader and writer threads, no stage timed) in the
        # same turns. Every graph is captured already. The parent's eager
        # device stage is timed beside this one by ``serving_turns.py``.
        splits = []
        stages = {"_read_and_decode": "decode", "process_batch": "upload_and_device",
                  "_to_host": "download", "_encode_chunk": "encode"}
        saved = {name: getattr(serving, name) for name in stages}

        def timed(name, split):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                out = saved[name](*args, **kwargs)
                torch.cuda.synchronize()
                split[stages[name]] += time.perf_counter() - t0
                return out
            return wrapper

        for i in range(3):
            split = collections.Counter()
            splits.append(split)
            for name in stages:
                setattr(serving, name, timed(name, split))
            try:
                serve_run(f"sequential {i}", ["--sequential", "--preset", PRESETS,
                                              "--suffix", ".seq", *files])
            finally:
                for name, fn in saved.items():
                    setattr(serving, name, fn)
            split["sequential wall"] = serve_walls[f"sequential {i}"][0]
            for label, argv in (("presets", ["--preset", PRESETS]),
                                ("fanout", ["--fanout", fanout_flags])):
                serve_run(f"overlapped {label} {i}", [*argv, "--suffix", ".seq", *files])
                split[f"overlapped {label} wall"] = serve_walls[f"overlapped {label} {i}"][0]
        split_line = (f"phase 6 serve over {n_good} files on {card}, s, --sequential presets split "
                      f"and overlapped walls, three turns: " + "; ".join(
                          f"{key} " + ", ".join(f"{split[key]:.4f}" for split in splits)
                          for key in splits[0]))

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
        phase7, (mega_us, mega_events), (graph_us, graph_events) = phase_7(
            torch, dev, card, drive, path_counts, serve_run, serve_walls, files, bad,
            fanout_flags, n_good, plain_presets, trace_dir)

        # Phase 8: images of 2^31 bytes and more.
        phase8, large = phase_8(torch, dev, card)
    finally:
        shutil.rmtree(tmp)
    loop_ratio = loop_ms * 1e3 / mega_us
    print(f"phase 5 flagship mega timing on {card}: device_loop_rate {loop_ms:.4f} ms per "
          f"iteration ({REPS} iterations and their feedback in one CUDA graph, median of 5), "
          f"{loop_ratio:.3f} x the device us; dispatch_time {dispatch_ms:.4f} ms (one replay "
          f"and a one-element fetch); ms per call eager {flagship_ms['mega']:.4f}, compiled "
          f"{flagship_ms['compiled mega']:.4f}; device us per call eager {mega_us:.2f} "
          f"({mega_events} device events), compiled {graph_us:.2f} ({graph_events} events, "
          f"copy-in and clone included) (phase 7: trace_to, {REPS} calls on its 4K image in a "
          f"span)")
    if not 0.8 <= loop_ratio <= 2.5:
        fail(f"device_loop_rate of mega is {loop_ratio:.3f} x its traced device time, "
             f"outside [0.8, 2.5]")
    for label, n_files in (("presets", len(files)), ("fanout", 8)):
        wall = serve_walls[label][0]
        print(f"phase 6 serving {label}: {n_files} files in {wall:.3f} s "
              f"({n_files / wall:.2f} files/s) on {card}; serve said: "
              f"{serve_walls[label][1].splitlines()[-1]}")
    print(f"phase 6 serving: {n_checked} outputs byte-equal to the plain bodies on the card and "
          f"to the eager loop on the same decoded images; 768x1024 cuda and cpu outputs "
          f"byte-equal {cross_worst}; native codec built")
    for line in (graph_line, chunk_line, form_line, split_line):
        print(line)
    for line in phase7 + phase8:
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
        if name in large or name == "stencil3":  # phase 8; K7's is Sobel's
            entry["large"] = large["sobel" if name == "stencil3" else name]
        if name == "fused_elementwise":  # off the paths: the full chain
            entry.update(full_chain_ms=times["fused_elementwise_full_chain"][0],
                         full_chain_plain_ms=times["fused_elementwise_full_chain"][1])
        entries.append(entry)
    # The batched entries: times and least time at uint8[BATCH_N, 2160, 3840(, 3)],
    # beside the single-image kernel on each image in turn (per_image_ms), and
    # the card's time of both from CUDA graph replays (device_ms,
    # per_image_device_ms). No
    # single PyTorch call computes a histogram per image, a LUT per image or
    # the stencils, so library_ms is null.
    for name, single in BATCH_KERNELS.items():
        source, replaces = KERNELS[single]
        entry = {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{source}",
                 "replaces": replaces, "batch": BATCH_N, "bound_ms": batch_bounds[name][0],
                 "bound_by": batch_bounds[name][1], "library_ms": None}
        if name == "stencil3_batch":  # the three instances; Sobel's times
            instances = {k: {"launches": launches[k], "on_path": k not in OFF_PATH,
                             "max_abs_err": errs[k], "ms": batch_times[k][0],
                             "plain_ms": batch_times[k][1], "per_image_ms": batch_times[k][2],
                             "device_ms": batch_times[k][3],
                             "per_image_device_ms": batch_times[k][4]}
                         for k in STENCIL3_BATCH}
            entry.update(launches=sum(k["launches"] for k in instances.values()),
                         max_abs_err=max(k["max_abs_err"] for k in instances.values()),
                         **{key: instances["sobel_batch"][key] for key in
                            ("ms", "plain_ms", "per_image_ms", "device_ms",
                             "per_image_device_ms")}, instances=instances)
        else:
            entry.update(launches=launches[name], max_abs_err=errs[name],
                         **dict(zip(("ms", "plain_ms", "per_image_ms", "device_ms",
                                     "per_image_device_ms"), batch_times[name])))
        if name == "resize_pass_batch":  # two launches a call, 4K -> 1920; then 4K -> 256
            key = "resize_pass_batch_4k_to_256"
            entry.update({f"4k_to_256_{k}": v for k, v in zip(
                ("ms", "plain_ms", "per_image_ms", "device_ms", "per_image_device_ms"),
                batch_times[key])}, **{"4k_to_256_bound_ms": batch_bounds[key][0],
                                       "4k_to_256_bound_by": batch_bounds[key][1]})
        entries.append(entry)
    # K10, the port's own: no Pallas kernel, no single PyTorch call.
    entries.append({**dither_entry, "launches": launches["dither_pack_batch"],
                    "max_abs_err": errs["dither_pack_batch"]})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
