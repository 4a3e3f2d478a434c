"""The benchmark's data: a cell of ``BENCHMARK.json`` and the files its names lead to.

Nothing here names a cell, a configuration or a metric: a cell is found by its
name in ``BENCHMARK.json``, its configuration by the file that entry names, its
workload in ``workloads/<cell>.json``, and each code file (a traffic driver, a
metric's reader, a reference, a task's work) by its name under its folder.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` in ``BENCHMARK.json``, with what it names."""

    name: str
    chips: int
    config: dict           # configs/<config>.json
    workload: dict         # workloads/<cell>.json
    end_to_end: tuple      # the end-to-end metrics that this cell reports
    per_layer: tuple       # the per-layer metrics that this cell reports


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell called ``name``; raises ``KeyError`` where there is none and
    ``ValueError`` where its files disagree with ``BENCHMARK.json``."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    config_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(root / config_entry["file"])
    workload = load_json(BENCH / "workloads" / f"{name}.json")
    if workload["config"] != entry["config"] or workload["driver"] != entry["traffic"]:
        raise ValueError(f"workloads/{name}.json names {workload['config']} and "
                         f"{workload['driver']}, BENCHMARK.json {entry['config']} and "
                         f"{entry['traffic']}")
    e2e = tuple(m for m in bench["end_to_end"] if _reports(m, name, set()))
    names = {m["name"] for m in e2e}
    per_layer = tuple(m for m in bench["per_layer"] if _reports(m, name, names))
    return Cell(name, int(entry["chips"]), config, workload, e2e, per_layer)


def module(folder: str, name: str):
    """The module ``<folder>/<name>.py`` under the benchmark (a name may hold
    dots, so it is loaded from its path); raises ``FileNotFoundError``."""
    path = BENCH / folder / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"port_bench has no {folder}/{name}.py")
    key = f"port_bench.{folder}.{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def entry(ref: str):
    """The function that ``"package.module:function"`` names."""
    mod, _, attr = ref.partition(":")
    return getattr(importlib.import_module(mod), attr)
