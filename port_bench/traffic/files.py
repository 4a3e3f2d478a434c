"""A file campaign: P6 files written from the seed, served pass after pass.

Workload parameters: ``call`` (``"module:function"``, called as
``call(paths, *args, suffix=..., **kwargs)`` and returning the paths it
wrote), ``files`` (distinct files, read again each pass, from the page
cache), ``hook`` (the port's function whose output a control or fault run
replaces, see ``harness.patch``), ``stages`` (``{"module:function": name}``,
the port's functions whose host time a traced run sums) and ``stretch``
(passes in a traced run's profiled stretch). A unit is one pass over every
file; pass k writes ``<path>.p<k>.out``, so that every answer of the window
is checked.
"""

from __future__ import annotations

import importlib
import shutil

import torch

from port_bench import harness, spec


class Traffic:
    def __init__(self, run):
        wl = run.workload
        self.run = run
        self.paths, self.frames = harness.input_files(run, int(wl["files"]))
        self.fn, self.args = spec.entry(wl["call"]), wl.get("args", [])
        self.kwargs = wl.get("kwargs", {})
        self.name = wl["call"].rpartition(":")[2]
        self.images = len(self.paths)
        self.passes = []
        self.restore = harness.patch(run, wl["hook"])
        self._pass(".warm.out")  # the codec's build, the graph's capture, the kernels' build

    def _pass(self, suffix):
        return self.fn(self.paths, *self.args, suffix=suffix, **self.kwargs)

    def unit(self, k):
        written = self._pass(".warm.out" if k is None else f".p{k}.out")
        if k is not None:
            self.passes.append(k)
        n = len(self.paths)
        return {"answers": n, "files": len(written), "failed": n - len(written)}, {}

    def stages(self, stages):
        for ref, name in self.run.workload["stages"].items():
            mod, _, attr = ref.partition(":")
            stages.wrap(importlib.import_module(mod), attr, name)

    def check(self):
        want = harness.expected(self.run, torch.from_numpy(self.frames))
        files = [self.run.reference.file_bytes(out, self.run.config) for out in want]
        off = missing = 0
        for k in self.passes:
            for path, expected in zip(self.paths, files):
                got = harness.file_bytes_off(f"{path}.p{k}.out", expected)
                if got is None:
                    missing += 1
                else:
                    off += got
        return len(self.passes) * len(files), {"bytes_off": off, "missing": missing}

    def close(self):
        self.restore()
        shutil.rmtree(self.run.workdir, ignore_errors=True)
