"""Time ``serve`` and a card-resident batch in two checkouts of the
repository, in alternating turns, on one CUDA card.

    python imageprocessingtools_tpu_torch/serving_turns.py [--order a,b,b,a] \
        [--repeats 3] a=DIR b=DIR

Each ``NAME=DIR`` names the root of a checkout; ``--order`` (default: the
first, the second, the second, the first) says which checkout runs each
turn. A turn is a fresh process that imports ``imageprocessingtools_tpu_torch``
from its checkout, so two versions of the port are compared on the same
card in one call. The script is run by its path (not with ``-m``), so that
its own checkout does not shadow the other's.

Every turn serves the same P6 files, written once: eight 2160x3840 and two
1080x1920 noise images (seeds 40-49, as in ``chip_smoke.py`` phase 6). After
one warm-up run of each kind (the kernels' build, and in a checkout with
CUDA graphs their captures), it runs ``--repeats`` times, on the host clock:

- ``serve --sequential --preset edge_detect,enhance,print_ready,thumbnail``,
  with host seconds in ``serving._read_and_decode`` (decode),
  ``process_batch`` (upload and device), ``_to_host`` (download) and
  ``_encode_chunk`` (encode), each synchronised;
- the same presets and the fan-out ``-gray;-w1920 -r30`` with the reader
  and writer threads (walls only);
- the same presets and fan-out with ``--spatial`` (each file one image in
  row bands over the card; walls only).

Then, per preset and for the fan-out, ms per chunk of the eight 4K images
with the input already on the card, through ``parallel.batch.batch_apply``,
and ms per call of the fused pipeline and edge_detect on the first 4K image
on the card in four row bands of that card (``parallel/spatial.py``), each
CUDA events around 20 calls, median of 3. Each turn prints one JSON line,
with the sha256 of every output file it wrote; the last line gives each
checkout's medians and fails (exit 1) if two turns wrote different bytes.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

PRESETS = "edge_detect,enhance,print_ready,thumbnail"
FANOUT = "-gray;-w1920 -r30"
SHAPES = [(2160, 3840)] * 8 + [(1080, 1920)] * 2
REPS = 20


def write_files(folder: str) -> list:
    """The P6 files every turn serves."""
    files = []
    for i, (h, w) in enumerate(SHAPES):
        img = np.random.default_rng(40 + i).integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        files.append(os.path.join(folder, f"f{i}.ppm"))
        with open(files[-1], "wb") as f:
            f.write(f"P6\n{w} {h}\n255\n".encode() + img.tobytes())
    return files


def turn(root: str, folder: str, repeats: int) -> dict:
    """One turn in the checkout at ``root`` (see the module's docstring)."""
    sys.path[0] = root  # this checkout's package, not the script's
    import torch

    from imageprocessingtools_tpu_torch import serve, serving
    from imageprocessingtools_tpu_torch.parallel import spatial
    from imageprocessingtools_tpu_torch.parallel.batch import batch_apply
    from imageprocessingtools_tpu_torch.pipeline import PipelineConfig

    if not serving.__file__.startswith(os.path.realpath(root)):
        raise SystemExit(f"serving_turns: imported {serving.__file__}, not from {root}")
    files = sorted((os.path.join(folder, n) for n in os.listdir(folder) if n.endswith(".ppm")),
                   key=lambda p: int(os.path.basename(p)[1:-4]))

    def wall(argv) -> float:
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = serve.main(argv)
        torch.cuda.synchronize()
        if rc != 0:
            raise SystemExit(f"serving_turns: serve {argv[:2]} exited {rc}: {err.getvalue()}")
        return time.perf_counter() - t0

    sequential = ["--sequential", "--preset", PRESETS, *files]
    overlapped = {"presets": ["--preset", PRESETS, *files], "fanout": ["--fanout", FANOUT, *files]}
    overlapped.update({f"spatial {label}": ["--spatial", "--suffix", ".spatial", *argv]
                       for label, argv in overlapped.items()})
    for argv in (sequential, *overlapped.values()):
        wall(argv)

    stages = {"_read_and_decode": "decode", "process_batch": "upload_and_device",
              "_to_host": "download", "_encode_chunk": "encode"}
    saved = {name: getattr(serving, name) for name in stages}
    runs = []
    for _ in range(repeats):
        split = dict.fromkeys(stages.values(), 0.0)

        def timed(name):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                out = saved[name](*args, **kwargs)
                torch.cuda.synchronize()
                split[stages[name]] += time.perf_counter() - t0
                return out
            return wrapper

        for name in stages:
            setattr(serving, name, timed(name))
        try:
            split["sequential wall"] = wall(sequential)
        finally:
            for name, fn in saved.items():
                setattr(serving, name, fn)
        for label, argv in overlapped.items():
            split[f"overlapped {label} wall"] = wall(argv)
        runs.append(split)

    chunk = torch.from_numpy(np.stack([
        np.random.default_rng(40 + i).integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        for i, (h, w) in enumerate(SHAPES[:8])])).to("cuda")
    tasks = {**{name: name for name in PRESETS.split(",")},
             "fanout": (PipelineConfig(gray=True), PipelineConfig(new_width=1920, angle=30.0))}
    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        samples = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / REPS)
        return statistics.median(samples)

    chunk_ms = {}
    for label, task in tasks.items():
        one, _ = serving._task_fn(task)
        chunk_ms[label] = ms(lambda: batch_apply(one, chunk))
    img, mesh4 = chunk[0], (torch.device("cuda", torch.cuda.current_device()),) * 4
    chunk_ms["fused in 4 bands"] = ms(lambda: spatial.fused_pipeline_spatial(img, mesh4))
    chunk_ms["edge_detect in 4 bands"] = ms(
        lambda: spatial.preset_pipeline_spatial(img, "edge_detect", mesh4))

    digest = hashlib.sha256()
    for name in sorted(n for n in os.listdir(folder) if n.endswith((".out", ".spatial"))):
        with open(os.path.join(folder, name), "rb") as f:
            digest.update(name.encode() + f.read())
    return {"runs": runs, "chunk_ms": chunk_ms, "outputs_sha256": digest.hexdigest()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="*", help="NAME=DIR, the root of a checkout (two)")
    parser.add_argument("--order", help="comma-separated names, one per turn")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--turn", nargs=2, metavar=("ROOT", "FOLDER"), help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.turn:
        print(json.dumps(turn(*args.turn, args.repeats)), flush=True)
        return 0
    if len(args.trees) != 2:
        parser.error("give two checkouts, NAME=DIR each")
    trees = dict(t.split("=", 1) for t in args.trees)
    names = list(trees)
    order = args.order.split(",") if args.order else [names[0], names[1], names[1], names[0]]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    results = {name: [] for name in names}
    with tempfile.TemporaryDirectory() as folder:
        write_files(folder)
        for i, name in enumerate(order):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--turn",
                 os.path.realpath(trees[name]), folder, "--repeats", str(args.repeats)],
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                raise SystemExit(f"serving_turns: turn {i} ({name}) exited {proc.returncode}")
            result = json.loads(proc.stdout.strip().splitlines()[-1])
            results[name].append(result)
            print(json.dumps({"turn": i, "tree": name, **result}), flush=True)
    digests = {r["outputs_sha256"] for rs in results.values() for r in rs}
    summary = {}
    for name, rs in results.items():
        runs = [run for r in rs for run in r["runs"]]
        summary[name] = {
            "runs": len(runs),
            "median_s": {k: statistics.median(run[k] for run in runs) for k in runs[0]},
            "range_s": {k: [min(run[k] for run in runs), max(run[k] for run in runs)]
                        for k in runs[0]},
            "chunk_ms": {k: [r["chunk_ms"][k] for r in rs] for k in rs[0]["chunk_ms"]}}
    print(json.dumps({"same_outputs": len(digests) == 1, **summary}), flush=True)
    return 0 if len(digests) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
