"""Run one cell of the port's benchmark once, on one card.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s`` of the traced stretch,
and a ``breakdown``), ``compared`` (answers checked) and, last, ``checks``:
each number compared with the reference beside its limit, which the last
lines of standard error repeat. The port's builds are kept in
``port_bench/.cache/``, so only a checkout's first run compiles; an earlier
line on standard error says how long the kernel library took to load or
build. Without a CUDA card, outside a checkout that holds the port, or with
``jax``, ``jaxlib``, ``flax`` or the JAX package loaded, the run exits with a
non-zero code and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from port_bench import spec

# Compared by whole top-level names: the port's name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "imageprocessingtools_tpu")
PORT = "imageprocessingtools_tpu_torch"


def forbidden(modules) -> list[str]:
    """The top-level names among ``modules`` that a run may not have loaded."""
    return sorted({name.partition(".")[0] for name in modules} & set(FORBIDDEN))


def environment() -> None:
    """The card, and every build and kernel cache inside the checkout, at
    fixed paths, before the port is imported."""
    cache = spec.BENCH / ".cache"
    os.environ["IPT_DEVICE"] = "cuda"
    os.environ["IPT_CACHE_DIR"] = str(cache)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = spec.cell(args.workload)
    environment()

    import torch

    try:
        port = __import__(PORT)
    except ImportError as e:
        print(f"port_bench: cannot import the port: {e}", file=sys.stderr)
        return 2
    if not os.path.realpath(port.__file__).startswith(str(spec.ROOT) + os.sep):
        print(f"port_bench: imported {port.__file__}, not the checkout's port", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from imageprocessingtools_tpu_torch.kernels import _build

    from port_bench import harness

    built = not _build.library_path().exists()
    t0 = time.perf_counter()
    _build.library()
    print(f"port_bench: kernel library {'built' if built else 'loaded'} in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)

    device = torch.device("cuda", 0)
    workdir = tempfile.mkdtemp(prefix="port_bench-")
    try:
        line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                                workdir, harness.process_start())
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = forbidden(sys.modules)
    if bad:
        print(f"port_bench: loaded {', '.join(bad)}; the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    for name, check in line["checks"].items():
        print(f"{name} {check['value']} limit {check['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
