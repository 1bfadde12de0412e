"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import json
import math
import re

import pytest

from benchmark import manifest

BENCH = manifest.load()
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
TEXT = re.compile(r"[^\t\n]{1,200}")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.fullmatch(w) for w in BENCH["command"])
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_seconds_fit_a_full_check():
    per_run = BENCH["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = [e["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[sec]]
    assert len(names) == len(set(names))
    for name in names:
        assert manifest.NAME.fullmatch(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert manifest.UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_found_by_name(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("benchmark/configs/")
    with open(manifest.ROOT / entry["file"]) as f:
        config = json.load(f)
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"] == []
    assert (manifest.HERE / "families" / f"{config['family']}.py").exists()
    assert (manifest.HERE / "reference" / f"{config['family']}.py").exists()
    assert "check" not in config  # a cell's check is the cell's own
    assert TEXT.fullmatch(entry["why"]) and TEXT.fullmatch(entry["source"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and TEXT.fullmatch(w["why"])
    assert manifest.NAME.fullmatch(w["traffic"]) and manifest.NAME.fullmatch(w["config"])
    cell = manifest.cell(BENCH, w["name"])
    assert hasattr(cell["kind"], "run") and hasattr(cell["family"], "reference_chunk")
    assert hasattr(cell["family"], "step_chunk")
    assert 0 < cell["check"]["tol"] and cell["check"]["limits"]
    assert all(0 < v < 1 for v in cell["check"]["limits"].values())
    reported = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in reported


def test_end_to_end_metrics():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and not math.isnan(m["bound"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_found_by_name(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert TEXT.fullmatch(m["layer"])
    assert m["moves"] in E2E
    for w in m.get("workloads", []):
        assert "workloads" not in E2E[m["moves"]] or w in E2E[m["moves"]]["workloads"]
    assert callable(manifest.metric_reader(m["name"]).read)
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"device", "vector env", "kernels"}
