"""Whole runs of each cell on the port's CPU path at small sizes: the result
line's schema, ``correct`` for the program, and ``correct`` false where the
timed path is broken underneath or the control stands in for it."""

import json
import shutil
import subprocess
import sys

import pytest

from port_bench import run as bench_run
from port_bench import spec
from port_bench.tests.helpers import CELLS, run_small

# The faults each cell can have: an answer altered where it is produced, half
# of a batch left out, a stale answer.
FAULTS = [(cell, fault) for cell in CELLS for fault in ("alter", "half", "stale")]


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct_and_its_line_keeps_the_schema(on_cpu, tmp_path, cell):
    line = run_small(cell, tmp_path)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["compared"] > 0
    names = {m["name"] for m in spec.cell(cell).end_to_end}
    assert set(line["metrics"]) == names
    for name, m in line["metrics"].items():
        assert m["value"] > 0 and m["unit"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for check in line["checks"].values():
        assert check["value"] <= check["limit"] == 0
    json.dumps(line)


@pytest.mark.parametrize("cell, fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(on_cpu, tmp_path, cell, fault):
    line = run_small(cell, tmp_path, substitute=f"fault:{fault}")
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(on_cpu, tmp_path, cell):
    line = run_small(cell, tmp_path, substitute="control")
    assert line["correct"] is False and line["checks"]["bytes_off"]["value"] > 0


def test_the_import_guard_compares_whole_top_level_names():
    assert bench_run.forbidden(["imageprocessingtools_tpu_torch.serving", "numpy"]) == []
    assert bench_run.forbidden(["jax.numpy", "jaxlib", "flax.linen", "jaxtyping"]) == [
        "flax", "jax", "jaxlib"]
    assert bench_run.forbidden(["imageprocessingtools_tpu.ops"]) == ["imageprocessingtools_tpu"]


def _run(cwd, *args):
    return subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                           "flagship_4k.resident", "--seed", "1", "--seconds", "1", *args],
                          cwd=cwd, capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(cwd), "TMPDIR": str(cwd),
                               "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result(tmp_path):
    proc = _run(spec.ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_a_directory_with_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "cannot import the port" in proc.stderr
