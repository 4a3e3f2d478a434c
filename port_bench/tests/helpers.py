"""Small cells for the CPU tests of the port's benchmark."""

import dataclasses
import time

import torch

from port_bench import harness, spec

# A size at which the thumbnail downscales with many taps (so that its
# float32 control differs from the float64 reference) and a run stays short.
SMALL = {"flagship_4k": {"height": 48, "width": 80},
         "thumbnail_4k": {"height": 90, "width": 640}}


def small_cell(name: str, **workload):
    """The cell ``name`` of BENCHMARK.json at a small size: its
    configuration's sizes from ``SMALL``, its workload's counts cut, and
    ``workload`` over them."""
    cell = spec.cell(name)
    config = dict(cell.config, **SMALL[cell.config["name"]])
    wl = dict(cell.workload, stretch=2)
    for key, most in (("groups", 3), ("files", 16), ("keep", 8)):
        if key in wl:
            wl[key] = min(wl[key], most)
    wl.update(workload)
    return dataclasses.replace(cell, config=config, workload=wl)


def run_small(name: str, tmp_path, substitute=None, seed=2**31 + 17, seconds=0.3,
              device="cpu", **workload):
    """One run of the small cell on ``device``; its result line's object."""
    workdir = tmp_path / f"run-{name}-{substitute}"
    workdir.mkdir()
    return harness.run_cell(small_cell(name, **workload), seed, seconds, False,
                            torch.device(device), str(workdir), time.perf_counter(), substitute)


CELLS = ["flagship_4k.resident", "thumbnail_4k.files", "thumbnail_4k.resident"]
