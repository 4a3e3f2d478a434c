"""BENCHMARK.json keeps the benchmark's contract, and the harness finds every
cell, configuration, driver, reference, work count and metric by name."""

import json
import re

import pytest

from port_bench import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expan")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["command"][:3] == ["python3", "-m", "port_bench.run"]
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_just_the_contract_keys(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) <= KEYS[section] and set(e) >= KEYS[section] - {"workloads"}, e
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e and section != "end_to_end" and section != "per_layer":
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_metric_sources_and_bounds():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_with_what_it_names(cell):
    c = spec.cell(cell)
    assert c.chips == 1
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:  # every per-layer metric moves one this cell reports
        assert m["moves"] in e2e
    assert hasattr(spec.module("traffic", c.workload["driver"]), "Traffic")
    assert len(c.workload["why"]) <= 200
    assert c.workload["why"] == next(w["why"] for w in BENCH["workloads"] if w["name"] == cell)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_every_configuration_has_its_files(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    data = spec.load_json(spec.ROOT / entry["file"])
    assert data["name"] == config and data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"]
    assert not any(WIDTHS.search(k) for k in entry["reduced"])
    assert set(data["limits"]) >= {"bytes_off", "missing"}
    ref = spec.module("reference", config)
    assert callable(ref.expected) and callable(ref.control)
    assert callable(spec.module("work", config).per_image)
    assert any(w["config"] == config for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.module("metrics", metric).read)


def test_a_cell_that_is_not_there_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no_such.cell")


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
