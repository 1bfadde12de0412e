"""LightDark-v0 as the benchmark builds it, draws for it, reads its
outputs and checks them.

* The env: ``apx_torch.make_vec(env_id, N)``, the registered
  ``TimeLimit(LightDarkEnv, 50, issue_termination=True)`` under NEXT_STEP
  autoreset; every step of a chunk is ``venv.step`` with its step draws
  and its reset draws injected.
* The draws of a step: the policy's action and prediction, the step's
  observation noise, and every env's reset position and reset noise. The
  env calls both noises ``noise``; the pool names them apart
  (``step_noise``, ``reset_noise``), since the rollout keeps one buffer
  per pool key. The initial reset's draws are made the same way and
  injected.
* The check: the explicit reset, and the first chunk after it, are
  followed by the reference from the draws alone; a chunk of the window
  from the program's state at its start (the position, the step count and
  ``prev_done``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..reference import light_dark as ref

__all__ = ["Env", "build", "draw_pool", "initial_reset", "step_chunk", "program_leaves",
           "reference_reset", "reference_chunk", "least_seconds", "OBS_KEYS"]

OBS_KEYS = ("noisy_position", "time_step")


@dataclasses.dataclass
class Env:
    venv: object
    params: object
    num_envs: int
    chunk: int
    device: torch.device


def build(config: dict, traffic: dict, seed: int, dev: torch.device) -> Env:
    import apx_torch

    venv, params = apx_torch.make_vec(config["env_id"], traffic["num_envs"], device=dev)
    stated = (tuple(config["light_pos"]), config["light_height"], config["noise_scale"],
              config["move_scale"], config["time_limit"], config["issue_termination"],
              config["autoreset"])
    built = (tuple(params.light_pos), params.light_height, params.noise_scale,
             params.move_scale, venv.env.max_episode_steps, venv.env.issue_termination,
             venv.autoreset.value)
    if built != stated:
        raise ValueError(f"the env has (light, height, noise, move, time limit, termination, "
                         f"autoreset) {built}, the configuration {stated}")
    return Env(venv=venv, params=params, num_envs=traffic["num_envs"],
               chunk=traffic["graph_steps"], device=dev)


def draw_pool(env: Env, gen: torch.Generator, steps: int) -> dict:
    """The draws of ``steps`` steps, each with a leading step axis: actions
    uniform in [-1, 1), standard-normal predictions, the step's noise, the
    reset's positions uniform in [-1, 1)^2 and the reset's noise (each
    noise ``randn * sqrt(1/2)``, the env's N(0, 1/2) draws)."""
    shape, dev = (steps, env.num_envs, 2), env.device

    def uniform():
        return torch.rand(shape, generator=gen, device=dev) * 2.0 - 1.0

    def noise():
        return torch.randn(shape, generator=gen, device=dev) * math.sqrt(0.5)

    return {"action": uniform(), "prediction": torch.randn(shape, generator=gen, device=dev),
            "step_noise": noise(), "reset_pos": uniform(), "reset_noise": noise()}


def _reset_draws(draws: dict, j: int) -> dict:
    return {"pos": draws["reset_pos"][j], "noise": draws["reset_noise"][j]}


def initial_reset(env: Env, gen: torch.Generator, policy):
    """(obs, state, draws) of the program's explicit reset from injected
    draws; the first chunk steps from there."""
    d = draw_pool(env, gen, 1)
    draws = {k: d[k][0] for k in ("reset_pos", "reset_noise")}
    obs, state, _ = env.venv.reset(env.params, draws=_reset_draws(d, 0))
    return obs, state, draws


def step_chunk(env: Env, obs: dict, state, draws: dict, racc: torch.Tensor,
               dacc: torch.Tensor, policy):
    """Every step of the chunk (the leading axis of ``draws``) is
    ``venv.step`` with its injected step and reset draws; rewards and
    terminations are added into the accumulators in place."""
    for j in range(draws["action"].shape[0]):
        full = {"action": policy(draws["action"][j], obs), "prediction": draws["prediction"][j]}
        obs, state, reward, term, *_ = env.venv.step(
            state, full, env.params, reset_draws=_reset_draws(draws, j),
            step_draws={"noise": draws["step_noise"][j]})
        racc.add_(reward)
        dacc.add_(term)
    return obs, state


def program_leaves(obs: dict, state) -> dict:
    """The program's outputs and carried state, by the reference's names."""
    return {**{k: obs[k] for k in OBS_KEYS}, "pos": state.inner.inner.pos, "t": state.inner.t,
            "prev_done": state.prev_done}


def reference_reset(env: Env, draws: dict, dtype) -> dict:
    """The reference's outputs of the explicit reset from ``draws``."""
    obs, state = ref.reset(draws["reset_pos"], draws["reset_noise"], dtype)
    return {**obs, **state}


def reference_chunk(env: Env, before: dict, draws: dict, prev_draws: dict, dtype, policy,
                    record: dict | None = None) -> dict:
    """The reference's outputs after the chunk whose draws are ``draws``
    (leading step axis), from the state ``before`` at the chunk's start
    (the program's ``program_leaves``, or the reference's own reset)."""
    state = {"pos": before["pos"].to(dtype), "t": before["t"].to(torch.int64),
             "prev_done": before["prev_done"]}
    obs = {k: before[k] for k in OBS_KEYS}
    rsum = torch.zeros(env.num_envs, dtype=dtype, device=state["pos"].device)
    tcount = torch.zeros(env.num_envs, dtype=torch.int64, device=state["pos"].device)
    for j in range(draws["action"].shape[0]):
        obs, state, reward, term, _ = ref.vector_step(
            state, policy(draws["action"][j], obs), draws["prediction"][j],
            draws["step_noise"][j], draws["reset_pos"][j], draws["reset_noise"][j])
        rsum += reward
        tcount += term
    return {**obs, **state, "reward_sum": rsum, "term_count": tcount}


def least_seconds(env: Env, record: dict) -> dict:
    """No kernel of this cell has a roofline metric: nothing."""
    return {}
