"""One run of one cell: set-up, the measured window, the traced stretch, the check.

A traffic driver (``traffic/<driver>.py``) defines ``Traffic(run)``, whose
construction is the cell's set-up (inputs made from the seed, its own shapes
warmed up), and whose methods are:

- ``unit(k)``: one unit of work (a group call, a pass over the file set),
  ended on the host after the device; ``k`` is its index in the
  window, or None for a unit outside it. Returns ``(counts, samples)``:
  amounts that the window adds up (``answers``, ``failed``, ``mpix``,
  ``files``, ...) and per-unit readings (``call_ms``);
- ``images``: the images in one unit, and ``name``: what a unit calls;
- ``stages(stages)``: wraps the port's functions whose host time the
  per-layer metrics read (traced runs only);
- ``check()``: ``(answers compared, {check: value})`` against the
  reference, after the window;
- ``close()``: puts back what it patched and deletes its files.

``run_cell`` drives it and returns the result line. A plain run measures
with nothing wrapped; a traced run (``trace``) wraps the stages, profiles one
unit, then in the middle of its window profiles ``stretch`` units (the
workload's) and reads the per-layer metrics from them.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import os
import random
import sys
import time

import numpy as np
import torch

from port_bench import spec, tracing


@dataclasses.dataclass
class Window:
    """What the measured window did: its units' span on the host clock, the
    amounts its units added up and their per-unit readings."""

    start: float = 0.0
    end: float = 0.0
    units: int = 0
    counts: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    samples: dict = dataclasses.field(default_factory=lambda: collections.defaultdict(list))

    @property
    def span_s(self) -> float:
        return self.end - self.start if self.units else 0.0


@dataclasses.dataclass
class Run:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    workdir: str
    # "control" (the reference's lower-precision control in the program's
    # place) or "fault:<kind>" (the program's output broken, see
    # ``substitute``); None for a measured run.
    substitute: str | None = None
    window: Window = dataclasses.field(default_factory=Window)
    stages: tracing.Stages | None = None
    stretch: tracing.Stretch | None = None
    setup_s: float | None = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def workload(self) -> dict:
        return self.cell.workload

    @property
    def reference(self):
        return spec.module("reference", self.config["name"])

    def least_s(self, images: int) -> float | None:
        """The least time ``images`` images of the task take on this card:
        the larger of their bytes at its bandwidth and their operations at
        their peaks (``work/<config>.py``, ``device/*.json``)."""
        peaks = device_peaks(self.device)
        if peaks is None:
            return None
        work = spec.module("work", self.config["name"]).per_image(self.config)
        ops_s = (work["f64_ops"] / peaks["f64_ops_per_s"]
                 + work["int_ops"] / peaks["int_ops_per_s"])
        return images * max(work["bytes"] / peaks["bytes_per_s"], ops_s)


def device_peaks(device: torch.device) -> dict | None:
    """The ``device/*.json`` whose ``match`` is in the card's name, or None."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for path in sorted((spec.BENCH / "device").glob("*.json")):
        peaks = spec.load_json(path)
        if peaks["match"] in name:
            return peaks
    return None


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """ms of one unit: CUDA events on an idle stream on a card (the card's
    clock, from the host's record of the start to the end of the unit's last
    work), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        if self.cuda:
            self.a.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            return self.a.elapsed_time(self.b)
        return (time.perf_counter() - self.t0) * 1e3


class Sample:
    """A uniform sample of at most ``size`` items of a stream of unknown
    length, drawn from the seed (reservoir sampling)."""

    def __init__(self, size: int, seed: int):
        self.size, self.items, self.rng = size, [], random.Random(seed)

    def offer(self, k: int, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(k + 1)
            if j < self.size:
                self.items[j] = item


def substitute(run: Run):
    """``(out, images) -> out`` that stands in for the program's output in
    ``run.substitute``'s runs, or None: the reference's ``control`` computed
    from the images, or a fault: ``alter`` flips one byte of the first
    answer, ``half`` gives the second half of the batch the first half's
    answers, ``stale`` answers with the previous call's outputs."""
    kind = run.substitute
    if kind is None:
        return None
    if kind == "control":
        return lambda out, images: run.reference.control(images.to(out.device), run.config)
    if kind == "fault:alter":
        def alter(out, images):
            out = out.contiguous().clone()
            out.view(-1)[0] ^= 1
            return out
        return alter
    if kind == "fault:half":
        def half(out, images):
            out, n = out.clone(), out.shape[0]
            out[n // 2:] = out[:n - n // 2]
            return out
        return half
    if kind == "fault:stale":
        last = []

        def stale(out, images):
            prev = last[0] if last else out
            last[:] = [out]
            return prev
        return stale
    raise ValueError(f"unknown substitute {kind!r}")


def patch(run: Run, hook: dict):
    """Put ``substitute(run)`` onto the output of the port's function that
    ``hook["call"]`` names (item ``hook["result"]`` of a tuple), a batch of
    images its first argument; returns what puts it back."""
    transform = substitute(run)
    if transform is None:
        return lambda: None
    mod_name, _, attr = hook["call"].partition(":")
    owner = importlib.import_module(mod_name)
    original = getattr(owner, attr)
    item = hook.get("result")

    def patched(images, *args, **kwargs):
        got = original(images, *args, **kwargs)
        out = transform(got if item is None else got[item], torch.as_tensor(images))
        if item is None:
            return out
        return tuple(out if i == item else g for i, g in enumerate(got))

    setattr(owner, attr, patched)
    return lambda: setattr(owner, attr, original)


def bytes_off(out: torch.Tensor, expected: torch.Tensor) -> int:
    """Output bytes that differ from the reference's (all of them where the
    shapes differ)."""
    if tuple(out.shape) != tuple(expected.shape) or out.dtype != expected.dtype:
        return max(out.numel(), expected.numel())
    return int((out.to(expected.device) != expected).sum())


def file_bytes_off(path: str, expected: bytes) -> int | None:
    """Bytes of the file at ``path`` that differ from ``expected``, or None
    where there is no file."""
    try:
        with open(path, "rb") as f:
            got = f.read()
    except FileNotFoundError:
        return None
    n = min(len(got), len(expected))
    a, b = np.frombuffer(got, np.uint8, n), np.frombuffer(expected, np.uint8, n)
    return int(np.count_nonzero(a != b)) + abs(len(got) - len(expected))


def expected(run: Run, images: torch.Tensor, block: int = 2) -> torch.Tensor:
    """The reference's outputs for ``images`` (uint8[N, H, W, 3]), computed on
    the run's device ``block`` images at a time."""
    outs = [run.reference.expected(images[i:i + block].to(run.device), run.config)
            for i in range(0, images.shape[0], block)]
    return torch.cat(outs)


def input_files(run: Run, n: int) -> tuple[list[str], np.ndarray]:
    """``n`` frames from the seed written as P6 files into the run's
    directory, flushed to the disk; (paths, the frames on the host)."""
    from port_bench import frames

    cfg = run.config
    imgs = frames.frames(n, cfg["height"], cfg["width"], run.seed, run.device).cpu().numpy()
    header = b"P6\n%d %d\n255\n" % (cfg["width"], cfg["height"])
    paths = []
    for i, img in enumerate(imgs):
        paths.append(os.path.join(run.workdir, f"in{i}.ppm"))
        with open(paths[-1], "wb") as f:
            f.write(header)
            f.write(img.data)
            f.flush()
            os.fsync(f.fileno())
    return paths, imgs


def _step(run: Run, traffic, k: int) -> None:
    t0 = time.perf_counter()
    counts, samples = traffic.unit(k)
    t1 = time.perf_counter()
    w = run.window
    if not w.units:
        w.start = t0
    w.end, w.units = t1, w.units + 1
    w.counts.update(counts)
    for name, value in samples.items():
        w.samples[name].append(value)
    if run.stages is not None:
        run.stages.record(traffic.name, t0, t1)


def _stretch(run: Run, traffic, k: int, per_unit: dict) -> int:
    """Profile ``stretch`` units of the window from unit ``k``, again where
    the trace lost events; returns the next unit's index."""
    units = int(run.workload["stretch"])

    def steps(n):
        nonlocal k
        for _ in range(n):
            _step(run, traffic, k)
            k += 1

    for _ in range(tracing.ATTEMPTS):
        # a tenth as many units lead in, inside the profile and before its marker
        events, t0 = tracing.profiled(lambda: steps(units), lambda: steps(max(1, units // 10)))
        lost = tracing.lost_events(tracing.marked(events), per_unit, units)
        if not lost:
            spans = [s for s in run.stages.spans if s[2] >= t0]
            run.stretch = tracing.Stretch.read(events, t0, units, traffic.images, spans)
            return k
        print(f"port_bench: the trace of units {k - units}-{k - 1} lost events: {lost}",
              file=sys.stderr)
    raise RuntimeError(f"the trace lost events in {tracing.ATTEMPTS} stretches")


def measure(run: Run, traffic) -> None:
    """The window: units back to back until ``run.seconds`` have passed
    since the first began; a traced run profiles a stretch in its middle."""
    per_unit = None
    if run.trace:
        events, _ = tracing.profiled(lambda: traffic.unit(None), lambda: traffic.unit(None))
        per_unit = collections.Counter(e["name"] for e in tracing.marked(events))
        run.stages = tracing.Stages()
        traffic.stages(run.stages)
    k, start = 0, time.perf_counter()
    while True:
        if per_unit is not None and run.stretch is None and \
                time.perf_counter() - start >= run.seconds / 2:
            k = _stretch(run, traffic, k, per_unit)
        _step(run, traffic, k)
        k += 1
        if run.window.end - start >= run.seconds:
            break
    if per_unit is not None and run.stretch is None:
        _stretch(run, traffic, k, per_unit)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             workdir: str, started: float, substitute: str | None = None) -> dict:
    """One run of ``cell`` on ``device``; ``started`` is the process's start
    on the host clock (``time.perf_counter``). Returns the result line's
    object. Files go to ``workdir``."""
    run = Run(cell, seed, seconds, trace, device, workdir, substitute)
    t0 = time.perf_counter()
    traffic = spec.module("traffic", cell.workload["driver"]).Traffic(run)
    try:
        run.setup_s = time.perf_counter() - started
        print(f"port_bench: set-up {run.setup_s:.3f} s, of which the cell's inputs and "
              f"warm-up {time.perf_counter() - t0:.3f} s", file=sys.stderr)
        try:
            measure(run, traffic)
        finally:
            if run.stages is not None:
                run.stages.restore()
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        compared, values = traffic.check()
    finally:
        traffic.close()
    limits = cell.config["limits"]
    checks = {name: {"value": value, "limit": limits[name]} for name, value in values.items()}
    failed = int(run.window.counts["failed"])
    correct = failed == 0 and compared > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": int(run.window.counts["answers"]),
            "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.stretch.busy_us() / 1e6
        dev["window_s"] = run.stretch.window_us / 1e6
        line["breakdown"] = run.stretch.breakdown()
    line["compared"] = compared
    line["checks"] = checks
    return line


def process_start() -> float:
    """When this process started, on the host clock (``time.perf_counter``),
    read from ``/proc`` (to a clock tick); now where that cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rpartition(")")[2].split()[19])
        return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now

