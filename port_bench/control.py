"""Read the numbers that a cell compares when the program is replaced by the
reference's control (the reference in the nearest precision below the one the
configuration states), on the card at the cell's own size:

    python3 -m port_bench.control --workload <cell> [--workload ...] --seeds 1,2,3 [--seconds 10]

Each seed is one run of the cell in this process, with the control standing
in for the program's output (``harness.substitute``) and a window of
``--seconds``; one JSON line per run gives its ``correct`` and its checks.
Exits 1 if any control run came out correct.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

from port_bench import run as bench_run
from port_bench import spec


def readings(name: str, seeds, seconds: float, device, substitute: str = "control") -> list:
    """One ``{"workload", "seed", "correct", "checks"}`` per seed."""
    from port_bench import harness

    cell, out = spec.cell(name), []
    for seed in seeds:
        workdir = tempfile.mkdtemp(prefix="port_bench-")
        try:
            line = harness.run_cell(cell, seed, seconds, False, device, workdir,
                                    time.perf_counter(), substitute)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        out.append({"workload": name, "seed": seed, "substitute": substitute,
                    "correct": line["correct"], "compared": line["compared"],
                    "checks": line["checks"]})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", action="append", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=10.0)
    args = parser.parse_args(argv)
    bench_run.environment()
    import torch

    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    passed = 0
    for name in args.workload:
        for reading in readings(name, seeds, args.seconds, torch.device("cuda", 0)):
            print(json.dumps(reading), flush=True)
            passed += reading["correct"]
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
