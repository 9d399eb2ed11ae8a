"""BENCHMARK.json holds to the benchmark's contract, and every part it
names loads by that name."""

from __future__ import annotations

import json
import re

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")

BENCH = spec.benchmark()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = set()
    for e in BENCH["configs"]:
        assert set(e) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(e["name"]) and _line(e["source"]) and _line(e["why"])
        assert e["file"].startswith("portbench/") and e["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        assert w["config"] in {c["name"] for c in BENCH["configs"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        for cell in m.get("workloads", []):
            spec.cell(BENCH, cell)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] == 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads_by_name(cell):
    w = spec.cell(BENCH, cell)
    cfg = spec.config(BENCH, w["config"])
    mix = spec.traffic(w["traffic"])
    app = spec.module("apps", cfg["app"])
    ref = spec.module("reference", cfg["app"])
    assert callable(app.build) and callable(ref.solve)
    assert mix["processes"] in (1, 4) and mix["inputs"] >= 2
    assert cfg["flops_per_step"] == app.flops(cfg)
    assert cfg["nb"] * cfg["b"] == cfg["N"]
    assert cfg["check"]["limit"] > 0
    reported = {m["name"] for m in spec.metrics(BENCH, "end_to_end", cell)}
    assert "setup_s" in reported and len(reported) >= 2
    assert spec.metrics(BENCH, "per_layer", cell)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_each_metric_has_a_reader(metric):
    assert callable(spec.module("metrics", metric).read)


def test_a_missing_part_is_refused():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.module("metrics", "no_such_metric")


def test_every_configuration_is_used_and_json_is_plain():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    json.dumps(BENCH, allow_nan=False)
