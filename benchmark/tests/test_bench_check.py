"""The check that decides ``correct``, driven through a whole run of each
cell on the CPU at a tiny size (the card's look skipped; each chunk is the
family's ``step_chunk`` called eagerly where the card replays its captured
graph): it passes the program as it is, and fails the control (the
reference in bfloat16 in the program's place) and the program with each
fault a rollout can have planted in its timed path."""

import dataclasses
import time

import pytest
import torch

from apx_torch.core import env as core_env
from apx_torch.core.env import tree_map

from benchmark import manifest, run as bench_run
from benchmark.control import CONTROL_DTYPES
from benchmark.kinds import rollout

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _cell(name: str) -> dict:
    cell = manifest.cell(BENCH, name)
    cell["traffic"] = {**cell["traffic"], "num_envs": 16, "graph_steps": 4, "pool_chunks": 4,
                       "check_range": 3, "check_block_envs": 8, "warm_seconds": 0}
    if cell["config"]["family"] == "image_loc":
        cell["config"] = {**cell["config"], "bank_images": 256}
    return cell


class _Eager:
    """The chunk stepped by the family's own function, in place of the
    card's captured graph."""

    def __init__(self, step, obs, state, draws):
        self.step = step
        self.static = tree_map(torch.clone, (obs, state))

    def replay(self, draws):
        out = self.step(*self.static, draws)
        tree_map(lambda d, s: d.copy_(s), self.static, out)


def _run(name: str, control=None) -> tuple[dict, dict]:
    cell = _cell(name)
    got = cell["kind"].run(cell, 2**31 + 12345, 3.0, False, time.perf_counter(), lambda m: None,
                           torch.device("cpu"), control=control, runner=_Eager)
    assert not got["problems"], got["problems"]
    return got, bench_run.result(cell, got, False, {"platform": "cpu"})


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_control_is_not(name):
    cell = _cell(name)
    got, out = _run(name, control=CONTROL_DTYPES[cell["config"]["precision"]])
    assert out["correct"] is True
    assert list(out)[-1] == "compared"
    limit = cell["check"]["limits"]["departing_share"]
    assert got["control"]["departing_share"] > limit
    assert set(out["metrics"]) == {"env_steps_per_s", "setup_s"}


def _unchanged(step):
    def broken(self, state, *args, **kwargs):
        out = step(self, state, *args, **kwargs)
        return (out[0], state, *out[2:])
    return broken


def _half(step):
    def broken(self, state, *args, **kwargs):
        obs, new, reward, *rest = step(self, state, *args, **kwargs)
        keep = torch.arange(self.num_envs) < self.num_envs // 2
        new = core_env.tree_select(keep, new, state)
        reward = torch.where(keep, reward, reward[keep].mean())
        return (obs, new, reward, *rest)
    return broken


def _altered(step):
    def broken(self, state, *args, **kwargs):
        obs, new, reward, *rest = step(self, state, *args, **kwargs)
        return (obs, new, reward + 0.01, *rest)
    return broken


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_the_batch", "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    for method in ("step", "boundary_reset_step"):
        monkeypatch.setattr(core_env.VectorAPEnv, method,
                            fault(getattr(core_env.VectorAPEnv, method)))
    _, out = _run(name)
    assert out["correct"] is False
    c = out["compared"]["departing_share"]
    assert c["value"] > c["limit"]


def test_carried_map_is_held_to_the_bank(monkeypatch):
    """A map carried wrong in the program's state (every env's, shifted a
    cell) departs, though the reference follows a chunk of the window from
    the program's state: each env's map is the bank's at its position."""
    step = core_env.VectorAPEnv.step

    def broken(self, state, *args, **kwargs):
        obs, new, *rest = step(self, state, *args, **kwargs)
        lidar = dataclasses.replace(new.inner.inner, occ=new.inner.inner.occ.roll(1, -1))
        new = dataclasses.replace(new, inner=dataclasses.replace(new.inner, inner=lidar))
        return (obs, new, *rest)

    monkeypatch.setattr(core_env.VectorAPEnv, "step", broken)
    _, out = _run("lidar_rooms.rollout")
    assert out["correct"] is False


@pytest.mark.parametrize("marks, two", [
    ([0.1 * i for i in range(100)], False),  # one rate: 20 chunks per 2 s
    ([0.0] * 30 + [0.1 * i for i in range(100)], False),  # the launch queue filled at first
    ([0.1 * i for i in range(40)] + [4.0 + 0.09 * i for i in range(67)], True),
])
def test_window_rates(marks, two):
    counts, found = rollout.rates(marks)
    assert found is two
    assert sum(counts) == len(marks)
