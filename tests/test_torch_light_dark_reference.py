"""LightDark-v0 on the CPU against the benchmark's plain reference
(``benchmark/reference/light_dark.py``, float64, written from ap_gym's
semantics and independent of the port): 120 NEXT_STEP steps with the step
and reset draws injected, episodes ending both by leaving the square and
at the 50-step limit. The reference computed in bfloat16 departs."""

import math

import pytest
import torch

import apx_torch
from apx_torch.core import trace
from benchmark import manifest
from benchmark.families import light_dark as family
from benchmark.reference import light_dark as ref

N = 32
STEPS = 120
TOL = 1e-5


def _draws(g, n):
    def noise():
        return torch.randn((n, 2), generator=g) * math.sqrt(0.5)

    return {"pos": torch.rand((n, 2), generator=g) * 2 - 1, "noise": noise()}, noise()


def _action(g, pos):
    """Envs 0, 4, 8, ... stand still (their episodes reach the time limit);
    the others walk at random, half of them pushed outwards (some leave
    the square), with actions beyond the unit ball."""
    a = torch.rand((N, 2), generator=g) * 2.5 - 1.25
    a[1::4] += torch.sign(pos[1::4]) * 0.8
    a[::4] = 0.0
    return a


def _gap(a, b):
    return float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vector_steps_follow_the_reference(seed):
    venv, params = apx_torch.make_vec("LightDark-v0", N, device="cpu")
    g = torch.Generator().manual_seed(seed)
    reset, _ = _draws(g, N)
    obs, state, _ = venv.reset(params, draws=reset)
    r_obs, r_state = ref.reset(reset["pos"], reset["noise"], torch.float64)
    l_obs, l_state = ref.reset(reset["pos"], reset["noise"], torch.bfloat16)
    ends = {"left": 0, "time": 0}
    low_gap = 0.0
    for _ in range(STEPS):
        leaves = family.program_leaves(obs, state)
        for key, want in {**r_obs, **r_state}.items():
            got = leaves[key]
            if want.is_floating_point():
                assert _gap(got, want) <= TOL, key
            else:
                assert torch.equal(got.long(), want.long()), key
        low_gap = max(low_gap, _gap(l_obs["noisy_position"], r_obs["noisy_position"]))
        act = _action(g, r_state["pos"].float())
        pred = torch.randn((N, 2), generator=g)
        reset, step_noise = _draws(g, N)
        obs, state, rew, term, trunc, _ = venv.step(
            state, {"action": act, "prediction": pred}, params, reset_draws=reset,
            step_draws={"noise": step_noise})
        args = (act, pred, step_noise, reset["pos"], reset["noise"])
        r_obs, r_state, r_rew, r_term, r_trunc = ref.vector_step(r_state, *args)
        l_obs, l_state, *_ = ref.vector_step(l_state, *args)
        assert _gap(rew, r_rew) <= TOL
        assert torch.equal(term, r_term) and torch.equal(trunc, r_trunc)
        ends["time"] += int((term & (r_state["t"] == ref.TIME_LIMIT)).sum())
        ends["left"] += int((term & (r_state["t"] < ref.TIME_LIMIT)).sum())
    assert ends["time"] >= N // 4 and ends["left"] >= N // 2, ends
    assert low_gap > 1e-3


def test_reference_states_the_configuration():
    config = manifest.cell(manifest.load(), "light_dark.rollout")["config"]
    assert (list(ref.LIGHT_POS), ref.LIGHT_HEIGHT, ref.NOISE_SCALE, ref.MOVE_SCALE,
            ref.OBS_CLIP, ref.TIME_LIMIT) == \
        (config["light_pos"], config["light_height"], config["noise_scale"],
         config["move_scale"], config["obs_clip"], config["time_limit"])
    assert config["autoreset"] == "next_step" and config["issue_termination"]


def test_build_refuses_other_constants():
    cell = manifest.cell(manifest.load(), "light_dark.rollout")
    traffic = {**cell["traffic"], "num_envs": 4}
    env = family.build(cell["config"], traffic, 0, torch.device("cpu"))
    assert env.num_envs == 4 and env.chunk == traffic["graph_steps"]
    with pytest.raises(ValueError, match="time limit"):
        family.build({**cell["config"], "time_limit": 100}, traffic, 0, torch.device("cpu"))


def test_injected_chunk_runs_the_step_and_the_reset_and_draws_nothing():
    """With every draw injected the vector step runs the env's step and its
    reset under their spans and makes no draw of its own."""
    cell = manifest.cell(manifest.load(), "light_dark.rollout")
    traffic = {**cell["traffic"], "num_envs": 8, "graph_steps": 3}
    env = family.build(cell["config"], traffic, 0, torch.device("cpu"))
    g = torch.Generator().manual_seed(4)
    obs, state, _ = family.initial_reset(env, g, lambda a, o: a)
    draws = family.draw_pool(env, g, 3)
    racc, dacc = torch.zeros(8), torch.zeros(8, dtype=torch.int32)
    with trace.timed() as times:
        family.step_chunk(env, obs, state, draws, racc, dacc, lambda a, o: a)
    assert {("apx.vector.step", "apx.env.step"), ("apx.vector.step", "apx.env.reset")} <= \
        set(times.total)
    assert times.seconds("env.draw") == 0.0
    assert racc.abs().sum() > 0
