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
   of 5 such runs);
4. the CLI (``imageprocessingtools_tpu_torch.cli.main``) over four 4K P6
   files, with a cross-check of a smaller file against the same CLI run on
   the CPU in a subprocess (``IPT_DEVICE=cpu``);
5. the flagship fused pipeline at 4K through K2 and K3, and its staged form
   through K5, K4 and K3, each byte-equal to the plain torch pipeline;
6. preset serving (``imageprocessingtools_tpu_torch.serve.main``): the four
   presets fanned out over eight 4K and two 1080p P6 files and one truncated
   file (``--skip-bad``), every output byte-equal to the presets' plain
   bodies on the same decoded image on the card; a reference-flag fan-out
   over the 4K files; and a cross-check of a smaller file against the same
   ``serve`` run on the CPU in a subprocess.

Every kernel's launch count is set to 0 just before each of phases 4, 5 and
6 and read just after it; a kernel that a phase's path uses and that was not
launched there is a failure. The line before the last is a JSON object with
each kernel's launches (summed over the three paths), error and times; the
last line is ``{"ok": true, "device": {...}}``. Any failure raises, and the
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
    "stencil3": ("stencil.cu", f"{PALLAS}:161"),
}
# K7's instances: the template's three wrappers. Box is on no path (no preset
# uses it); phase 3 holds it to its plain version.
STENCIL3 = ("box_blur", "sharpen", "sobel")
OFF_PATH = ("box_blur",)
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


def max_abs_err(torch, a, b) -> int:
    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max())


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
    from imageprocessingtools_tpu_torch import cli, device, serve
    from imageprocessingtools_tpu_torch.codec import native, ppm
    from imageprocessingtools_tpu_torch.kernels import _build, core, fused, rotate
    from imageprocessingtools_tpu_torch.ops import _exact, common
    from imageprocessingtools_tpu_torch.ops.color import grayscale
    from imageprocessingtools_tpu_torch.ops.dither import mono_dither
    from imageprocessingtools_tpu_torch.ops.histogram import _equalize_lut
    from imageprocessingtools_tpu_torch.ops.resize import resize_width

    dev = device.get_device()
    if dev.type != "cuda":
        fail(f"the configured device is {dev}, not cuda (is IPT_DEVICE set?)")

    wrappers = {
        "rotate": rotate.rotate_bicubic, "gray_gauss_hist": core.gray_gauss_hist,
        "lut_apply": core.lut_apply, "histogram": core.histogram,
        "gaussian_blur": core.gaussian_blur, "box_blur": core.box_blur,
        "sharpen": core.sharpen, "sobel": core.sobel,
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
    for src, angle in [
        (img4k, 30.0), (img4k, 135.0),
        (torch.from_numpy(image((1080, 1920), seed=2)).to(dev), 30.0),
        (torch.from_numpy(image((37, 53, 3), seed=3)).to(dev), 117.0),
    ]:
        check("rotate", rotate.rotate_bicubic(src, angle), rotate.rotate_plain(src, angle),
              f"{tuple(src.shape)} at {angle}")
    small = torch.from_numpy(image((5, W4K, 3), seed=4)).to(dev)
    for src in (img4k, small):
        blurred, hist = core.gray_gauss_hist(src)
        exp_blurred, exp_hist = core.gray_gauss_hist_plain(src)
        check("gray_gauss_hist", blurred, exp_blurred, f"{tuple(src.shape)} image")
        check("gray_gauss_hist", hist, exp_hist, f"{tuple(src.shape)} histogram")
    blurred, hist = core.gray_gauss_hist(img4k)
    lut = _equalize_lut(hist, H4K * W4K)
    check("lut_apply", core.lut_apply(blurred, lut), core.lut_apply_plain(blurred, lut), "4K")

    gray4k = grayscale(img4k)
    const4k = torch.full((H4K, W4K), 201, dtype=torch.uint8, device=dev)
    one = torch.from_numpy(image((1, 1), seed=5)).to(dev)
    for src, what in ((gray4k, "4K noise"), (const4k, "4K constant"), (one, "1x1")):
        check("histogram", core.histogram(src), core.histogram_plain(src), what)
    stencil_inputs = [gray4k] + [torch.from_numpy(image(s, seed=6 + i)).to(dev)
                                 for i, s in enumerate([(37, 53), (1, 7), (5, 1)])]
    edges4k = (gray4k > 127).to(torch.uint8) * 255  # reaches the clips and Sobel's largest m
    for name in ("gaussian_blur",) + STENCIL3:
        for src in stencil_inputs + [edges4k]:
            check(name, wrappers[name](src), plains[name](src), f"{tuple(src.shape)}")

    times = {
        "rotate": (median_ms(torch, lambda: rotate.rotate_bicubic(img4k, 30.0)),
                   median_ms(torch, lambda: rotate.rotate_plain(img4k, 30.0))),
        "gray_gauss_hist": (median_ms(torch, lambda: core.gray_gauss_hist(img4k)),
                            median_ms(torch, lambda: core.gray_gauss_hist_plain(img4k))),
        "lut_apply": (median_ms(torch, lambda: core.lut_apply(blurred, lut)),
                      median_ms(torch, lambda: core.lut_apply_plain(blurred, lut))),
        "histogram_constant": (median_ms(torch, lambda: core.histogram(const4k)),
                               median_ms(torch, lambda: core.histogram_plain(const4k))),
    }
    for name in plains:
        times[name] = (median_ms(torch, lambda: wrappers[name](gray4k)),
                       median_ms(torch, lambda: plains[name](gray4k)))
    print("phase 3 kernels byte-equal to plain at 4K and odd shapes; ms per call at 4K "
          f"(kernel / plain) on {card}: "
          + ", ".join(f"{k} {a:.4f} / {b:.4f}" for k, (a, b) in times.items()))

    tmp = tempfile.mkdtemp(prefix="ipt_chip_smoke_")
    try:
        # Phase 4: the CLI over four 4K files.
        rot30 = _exact.calc_rot_size(30.0, W4K, H4K)             # (w, h)
        rot30_1080 = _exact.calc_rot_size(30.0, 1920, 1080)
        rot135 = _exact.calc_rot_size(_exact.fold_angle(135.0), W4K, H4K)
        runs = [
            (["-r30"], ppm.FILETYPE_PPM, rot30),
            (["-w1920", "-r30", "-gray"], ppm.FILETYPE_PGM, rot30_1080),
            (["-r135", "-mono", "-fh"], ppm.FILETYPE_PBM, rot135),
            (["-w1920"], ppm.FILETYPE_PPM, (1920, 1080)),
        ]
        cli_paths = []
        for i in range(len(runs)):
            cli_paths.append(os.path.join(tmp, f"frame{i}.ppm"))
            ppm.write_ppm(cli_paths[-1], image((H4K, W4K, 3), seed=10 + i))
        walls = []

        def cli_runs():
            for path, (flags, _, _) in zip(cli_paths, runs):
                t0 = time.perf_counter()
                rc = cli.main(flags + [path])
                walls.append(time.perf_counter() - t0)
                if rc != 0:
                    fail(f"cli {flags} exited {rc}")

        n_rotating = sum(any(f.startswith("-r") for f in flags) for flags, _, _ in runs)
        path_counts = {"cli": drive("phase 4 cli", {"rotate": n_rotating}, cli_runs)}
        for path, (flags, file_type, (out_w, out_h)) in zip(cli_paths, runs):
            with open(path + ".out", "rb") as f:
                out, _, got_type = ppm.decode_pnm(f.read())
            if got_type != file_type or out.shape[:2] != (out_h, out_w):
                fail(f"cli {flags}: type {got_type} shape {out.shape}, "
                     f"want type {file_type} shape {(out_h, out_w)}")
        # Cross-check a smaller file against the same CLI on the CPU.
        small_img = image((768, 1024, 3), seed=20)
        budgets = {("-w640", "-r30", "-gray"): common.float_stage_budget(True),
                   ("-r135", "-mono"): common.float_stage_budget(False)}
        worst = {}
        for flags, budget in budgets.items():
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
            if budget == 0 and outs[0] != outs[1]:
                fail(f"cli {flags}: cuda and cpu outputs differ")
            if worst[" ".join(flags)] > budget:
                fail(f"cli {flags}: |cuda - cpu| {worst[' '.join(flags)]} > {budget}")
        print("phase 4 cli: " + ", ".join(
            f"{' '.join(flags)} {wall:.3f} s" for (flags, _, _), wall in zip(runs, walls))
            + f" per 4K file; 768x1024 cuda vs cpu max |diff| {worst}")

        # Phase 5: the flagship at 4K, through K2 and K3, and staged through K5, K4, K3.
        flagship = torch.from_numpy(image((H4K, W4K, 3), seed=30)).to(dev)
        results = {}

        def flagships():
            results["mega"] = fused.fused_pipeline_mega(flagship)
            results["staged"] = fused.fused_pipeline_staged(flagship)

        path_counts["flagship"] = drive(
            "phase 5 flagship",
            {"gray_gauss_hist": 1, "lut_apply": 2, "gaussian_blur": 1, "histogram": 1},
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

        # Per good file: edge_detect one K5 and one Sobel, enhance one K4, one
        # K3 and one sharpen, print_ready one K4 and one K3; the fan-out one
        # K1 per 4K file.
        n_good = len(files)
        path_counts["serving"] = drive(
            "phase 6 serving",
            {"gaussian_blur": n_good, "sobel": n_good, "sharpen": n_good,
             "histogram": 2 * n_good, "lut_apply": 2 * n_good, "rotate": 8},
            serving_runs)
        if f"skipped {bad}: Error: unexpected end of file." not in serve_walls["presets"][1]:
            fail(f"serve did not report the truncated file: {serve_walls['presets'][1]}")

        def equalize_plain(g):
            return core.lut_apply_plain(g, _equalize_lut(core.histogram_plain(g), g.numel()))

        plain_presets = {  # the presets' plain bodies, unpacked
            "edge_detect": lambda im: core.sobel_plain(core.gaussian_blur_plain(grayscale(im))),
            "enhance": lambda im: core.sharpen_plain(equalize_plain(grayscale(im))),
            "print_ready": lambda im: mono_dither(
                equalize_plain(grayscale(im))[..., None].expand(im.shape)),
            "thumbnail": lambda im: resize_width(im, 256),
            "gray": grayscale,
            "w1920-r30": lambda im: rotate.rotate_plain(resize_width(im, 1920), 30.0),
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
        cross_worst = {}
        for tag, (on_cuda, on_cpu) in cross.items():
            budget = common.float_stage_budget(tag in ("thumbnail", "w640-r30"))
            a, b = (ppm.decode_pnm(o)[0].astype(np.int32) for o in (on_cuda, on_cpu))
            if a.shape != b.shape:
                fail(f"serve {tag}: cuda shape {a.shape} != cpu shape {b.shape}")
            cross_worst[tag] = int(np.abs(a - b).max())
            if (budget == 0 and on_cuda != on_cpu) or cross_worst[tag] > budget:
                fail(f"serve {tag}: cuda and cpu differ by {cross_worst[tag]} (budget {budget})")
    finally:
        shutil.rmtree(tmp)
    for label, n_files in (("presets", len(files)), ("fanout", 8)):
        wall = serve_walls[label][0]
        print(f"phase 6 serving {label}: {n_files} files in {wall:.3f} s "
              f"({n_files / wall:.2f} files/s) on {card}; serve said: "
              f"{serve_walls[label][1].splitlines()[-1]}")
    print(f"phase 6 serving: {n_checked} outputs byte-equal to the plain bodies on the card; "
          f"768x1024 cuda vs cpu max |diff| {cross_worst}; native codec built")
    print("launches per path (counts set to 0 before each): "
          + "; ".join(f"{p} {c}" for p, c in path_counts.items())
          + f"; {', '.join(OFF_PATH)} is on no path (phase 3 holds it to plain)")

    launches = {name: sum(c[name] for c in path_counts.values()) for name in wrappers}
    k7 = {name: {"launches": launches[name], "on_path": name not in OFF_PATH,
                 "max_abs_err": errs[name], "ms": times[name][0], "plain_ms": times[name][1]}
          for name in STENCIL3}
    entries = []
    for name, (source, replaces) in KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{source}",
                 "replaces": replaces}
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
        entries.append(entry)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
