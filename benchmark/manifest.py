"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration's file is its entry's ``file``; the file's ``family``
  names ``benchmark/families/<family>.py`` (how the program is built,
  driven and read) and ``benchmark/reference/<family>.py`` (the plain
  reference);
* a traffic mix is ``benchmark/traffic/<traffic>.json``; its ``kind``
  names the general generator ``benchmark/kinds/<kind>.py``;
* a cell's own settings are ``benchmark/cells/<workload>.json``: its
  ``check``, the tolerance and the limit of each number that decides
  ``correct`` (a new cell on a configuration that is there brings its own);
* a per-layer metric's reader is ``benchmark/metrics/<name>.py``, whose
  ``read(ctx)`` returns the metric's value or None where it finds nothing
  to read.

A later cell, configuration, mix or metric is added by adding files and
entries, without editing a file that is there.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

__all__ = ["ROOT", "HERE", "NAME", "UNIT", "load", "cell", "metric_reader", "cell_metrics"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r}: {len(found)} entries in BENCHMARK.json")
    return found[0]


def cell_metrics(bench: dict, workload: str, section: str) -> list[dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those that list it, and those that list no cells (a
    per-layer metric without a list goes with every cell that reports the
    end-to-end metric it moves)."""
    reported = {m["name"] for m in bench["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in reported:
            out.append(m)
    return out


def cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """Everything one run of ``workload`` needs, found by name."""
    w = _by_name(bench["workloads"], workload, "workload")
    c = _by_name(bench["configs"], w["config"], "config")
    with open(root / c["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(HERE / "cells" / f"{workload}.json") as f:
        own = json.load(f)
    return {"workload": w, "config": config, "traffic": traffic, "check": own["check"],
            "family": importlib.import_module(f"benchmark.families.{config['family']}"),
            "kind": importlib.import_module(f"benchmark.kinds.{traffic['kind']}"),
            "end_to_end": cell_metrics(bench, workload, "end_to_end"),
            "per_layer": cell_metrics(bench, workload, "per_layer")}


def metric_reader(name: str):
    """The module of ``benchmark/metrics/<name>.py`` (names may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + re.sub(r"[^A-Za-z0-9_]", "_", name), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
