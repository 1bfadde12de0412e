"""A short run of each cell on the card, traced, with the control read
beside it: ``python -m pytest -p no:cacheprovider -o addopts="" benchmark/tests -m cuda``
on the H100 (these tests skip without a card)."""

import time

import pytest
import torch

from benchmark import manifest, run as bench_run

BENCH = manifest.load()


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(name, card):
    cell = manifest.cell(BENCH, name)
    cell["traffic"] = {**cell["traffic"], "num_envs": 1024, "warm_seconds": 1, "check_range": 8}
    got = cell["kind"].run(cell, 2**31 + 7, 2.0, True, time.perf_counter(), lambda m: None, card,
                           control=torch.bfloat16)
    out = bench_run.result(cell, got, True, {"platform": "gpu"})
    assert out["correct"] is True, out["compared"]
    assert got["control"]["departing_share"] > cell["check"]["limits"]["departing_share"]
    assert set(out["metrics"]) == {m["name"] for m in cell["per_layer"]}
    for name_, m in out["metrics"].items():
        if name_.endswith("_roofline"):
            assert 0.0 < m["value"] <= 100.0
    assert out["device"]["busy_s"] > 0 and out["breakdown"]["device_ops"]
