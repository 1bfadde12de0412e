"""Batched TimeLimit wrapper (counterpart of apx.wrappers.time_limit).

After ``max_episode_steps`` steps it sets ``terminated``
(``issue_termination``) or ``truncated``. With ``observe_time_steps``
(default = issue_termination) the observation carries ``2 t / T - 1``,
which is -1 on the reset observation: as a ``time_step`` key of a dict
observation, as the last element of a tuple observation, as one more
column of a 1-D Box observation ((N, D) batched, so ``ndim == 2``; apx's
per-env test is ``ndim == 1``), and otherwise as
``{"observation", "time_step"}``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.env import APEnv, APStepResult, _first_leaf
from ..core.numerics import time_obs
from ..core.spaces import Box, DictSpace, Space, TupleSpace
from .base import APWrapper

__all__ = ["TimeLimit", "TimeLimitState"]


@dataclasses.dataclass
class TimeLimitState:
    inner: Any
    t: torch.Tensor  # (N,) int32, steps elapsed


class TimeLimit(APWrapper):
    def __init__(
        self,
        env: APEnv,
        max_episode_steps: int,
        issue_termination: bool = False,
        observe_time_steps: bool | None = None,
    ):
        super().__init__(env)
        self.max_episode_steps = int(max_episode_steps)
        self.issue_termination = bool(issue_termination)
        self.observe_time_steps = (
            issue_termination if observe_time_steps is None else bool(observe_time_steps)
        )

    def observation_space(self, params) -> Space:
        inner = self.env.observation_space(params)
        if not self.observe_time_steps:
            return inner
        time_space = Box(low=-1.0, high=1.0, shape=())
        if isinstance(inner, DictSpace):
            return DictSpace({**inner.spaces, "time_step": time_space})
        if isinstance(inner, TupleSpace):
            return TupleSpace((*inner.spaces, time_space))
        if isinstance(inner, Box) and len(inner.shape) == 1:
            return Box(low=np.append(inner.low_arr, np.float32(-1.0)),
                       high=np.append(inner.high_arr, np.float32(1.0)),
                       shape=(inner.shape[0] + 1,), dtype=inner.dtype)
        return DictSpace({"observation": inner, "time_step": time_space})

    def _time_obs(self, t: torch.Tensor) -> torch.Tensor:
        return time_obs(t, self.max_episode_steps)

    def _wrap_obs(self, obs, t: torch.Tensor):
        if not self.observe_time_steps:
            return obs
        time_obs = self._time_obs(t)
        if isinstance(obs, dict):
            return {**obs, "time_step": time_obs}
        if isinstance(obs, tuple):
            return (*obs, time_obs)
        if isinstance(obs, torch.Tensor) and obs.ndim == 2:
            return torch.cat([obs, time_obs[:, None].to(obs.dtype)], dim=1)
        return {"observation": obs, "time_step": time_obs}

    def wrap_reset(self, obs, state, info, params):
        t = torch.zeros(_batch(obs), dtype=torch.int32, device=_device(obs))
        return self._wrap_obs(obs, t), TimeLimitState(inner=state, t=t), info

    def reset_from_draws(self, draws, params):
        obs, state, info = self.env.reset_from_draws(draws, params)
        return self.wrap_reset(obs, state, info, params)

    def autoreset_from_draws(self, draws, old_state, params):
        obs, state, info = self.env.autoreset_from_draws(draws, old_state.inner, params)
        return self.wrap_reset(obs, state, info, params)

    def step_env(self, state, action, prediction, params, draws=None) -> APStepResult:
        r = self.env.step_env(state.inner, action, prediction, params, draws)
        t = state.t + 1
        out_of_time = t >= self.max_episode_steps
        if self.issue_termination:
            terminated, truncated = r.terminated | out_of_time, r.truncated
        else:
            terminated, truncated = r.terminated, r.truncated | out_of_time
        return r.replace(
            obs=self._wrap_obs(r.obs, t),
            state=TimeLimitState(inner=r.state, t=t),
            terminated=terminated,
            truncated=truncated,
        )

    def prediction_target_on_reset(self, old_state, new_state, params):
        return self.env.prediction_target_on_reset(old_state.inner, new_state.inner, params)

    def obs_derived_from_state(self, state, params):
        return self.env.obs_derived_from_state(state.inner, params)


def _batch(obs) -> int:
    return _first_leaf(obs).shape[0]


def _device(obs) -> torch.device:
    return _first_leaf(obs).device
