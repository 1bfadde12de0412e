"""Batched TimeLimit wrapper (counterpart of apx.wrappers.time_limit).

After ``max_episode_steps`` steps it sets ``terminated``
(``issue_termination``) or ``truncated``. With ``observe_time_steps``
(default = issue_termination) the observation carries ``2 t / T - 1``,
which is -1 on the reset observation: as a ``time_step`` key of a dict
observation, as the last element of a tuple observation, as one more
column of a 1-D Box observation ((N, D) batched, so ``ndim == 2``; apx's
per-env test is ``ndim == 1``), and otherwise as
``{"observation", "time_step"}``.

The counter's rule is ``Counter``'s. ``TimeLimit.step_env`` applies it,
and so does the vector layer's NEXT_STEP merge, which keeps the counter
of a ``TimeLimit`` itself (``split_counter`` / ``join_counter``;
``ops.merge`` and the kernel ``ops.merge_cuda``, held against it).
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

__all__ = ["TimeLimit", "TimeLimitState", "Counter"]


@dataclasses.dataclass
class TimeLimitState:
    inner: Any
    t: torch.Tensor  # (N,) int32, steps elapsed


@dataclasses.dataclass(frozen=True)
class Counter:
    """A ``TimeLimit``'s step counter: ``t`` (N,) int32 the steps taken,
    ``limit`` the episode length, ``issue_termination`` whether running
    out of time terminates (else it truncates), ``observe`` whether the
    observation carries the time."""

    t: torch.Tensor
    limit: int
    issue_termination: bool
    observe: bool

    def tick(self, terminated: torch.Tensor, truncated: torch.Tensor):
        """One step: (t + 1, terminated, truncated), the step that reaches
        the limit terminating or truncating."""
        t = self.t + 1
        out_of_time = t >= self.limit
        if self.issue_termination:
            return t, terminated | out_of_time, truncated
        return t, terminated, truncated | out_of_time

    def time_obs(self, t: torch.Tensor) -> torch.Tensor:
        """The time observation ``2 t / limit - 1`` of the counts ``t``."""
        return time_obs(t, self.limit)


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

    def counter(self, t: torch.Tensor) -> Counter:
        return Counter(t, self.max_episode_steps, self.issue_termination,
                       self.observe_time_steps)

    def _time_obs(self, t: torch.Tensor) -> torch.Tensor:
        return self.counter(t).time_obs(t)

    def _wrap_obs(self, obs, t: torch.Tensor):
        return _attach_time_obs(obs, self._time_obs(t) if self.observe_time_steps else None)

    def split_counter(self, state):
        """The fused NEXT_STEP merge keeps this wrapper's counter itself:
        (the inner env, its state, the ``Counter``); ``join_counter``
        rebuilds the wrapper's obs and state. A subclass may change the
        rule, so its counter stays in its own ``step_env``."""
        if type(self) is not TimeLimit:
            return super().split_counter(state)
        return self.env, state.inner, self.counter(state.t)

    def join_counter(self, obs, state, t, time_obs):
        if type(self) is not TimeLimit:
            return super().join_counter(obs, state, t, time_obs)
        return _attach_time_obs(obs, time_obs), TimeLimitState(inner=state, t=t)

    def wrap_reset(self, obs, state, info, params):
        t = torch.zeros(_batch(obs), dtype=torch.int32, device=_device(obs))
        return self._wrap_obs(obs, t), TimeLimitState(inner=state, t=t), info

    def reset_from_draws(self, draws, params):
        obs, state, info = self.env.reset_from_draws(draws, params)
        return self.wrap_reset(obs, state, info, params)

    def autoreset_from_draws(self, draws, old_state, params, only=None):
        obs, state, info = self.env.autoreset_from_draws(draws, old_state.inner, params,
                                                         only=only)
        return self.wrap_reset(obs, state, info, params)

    def step_env(self, state, action, prediction, params, draws=None) -> APStepResult:
        r = self.env.step_env(state.inner, action, prediction, params, draws)
        t, terminated, truncated = self.counter(state.t).tick(r.terminated, r.truncated)
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


def _attach_time_obs(obs, time_obs: torch.Tensor | None):
    """``obs`` with the time observation (N,) attached (see the module
    docstring); ``obs`` itself when None."""
    if time_obs is None:
        return obs
    if isinstance(obs, dict):
        return {**obs, "time_step": time_obs}
    if isinstance(obs, tuple):
        return (*obs, time_obs)
    if isinstance(obs, torch.Tensor) and obs.ndim == 2:
        return torch.cat([obs, time_obs[:, None].to(obs.dtype)], dim=1)
    return {"observation": obs, "time_step": time_obs}


def _batch(obs) -> int:
    return _first_leaf(obs).shape[0]


def _device(obs) -> torch.device:
    return _first_leaf(obs).device
