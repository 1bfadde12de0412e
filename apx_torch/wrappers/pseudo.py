"""Pseudo active-perception adapter for plain (prediction-free) envs
(counterpart of apx.wrappers.pseudo): a plain env becomes an AP env with
``ZeroLossFn``, empty ``TupleSpace`` prediction and target spaces and
``()`` targets, so AP-generic code can drive it.

The plain env is batched like every env of the port and exposes
``default_params``, ``observation_space``, ``action_space``,
``draw_reset(num_envs, params, generator)``, ``reset_from_draws(draws,
params) -> (obs, state, info)`` and ``plain_step(state, action, params,
draws) -> (obs, state, reward, terminated, truncated, info)``, and
``draw_step`` if its step draws random numbers.
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.env import APEnv, APStepResult
from ..core.losses import LossFn, ZeroLossFn
from ..core.spaces import Space, TupleSpace

__all__ = ["PseudoActivePerceptionEnv"]


class PseudoActivePerceptionEnv(APEnv):
    def __init__(self, plain_env: Any):
        self.plain = plain_env

    def default_params(self, **overrides):
        return self.plain.default_params(**overrides)

    def observation_space(self, params) -> Space:
        return self.plain.observation_space(params)

    def inner_action_space(self, params) -> Space:
        return self.plain.action_space(params)

    def prediction_space(self, params) -> Space:
        return TupleSpace(())

    def prediction_target_space(self, params) -> Space:
        return TupleSpace(())

    def loss_fn(self, params) -> LossFn:
        return ZeroLossFn()

    def draw_reset(self, num_envs, params, generator):
        return self.plain.draw_reset(num_envs, params, generator)

    def reset_from_draws(self, draws, params):
        return self.plain.reset_from_draws(draws, params)

    def draw_step(self, num_envs, params, generator):
        draw = getattr(self.plain, "draw_step", None)
        return {} if draw is None else draw(num_envs, params, generator)

    def step_env(self, state, action, prediction, params, draws=None) -> APStepResult:
        obs, state2, reward, term, trunc, info = self.plain.plain_step(state, action, params, draws)
        return APStepResult(
            obs=obs,
            state=state2,
            base_reward=torch.broadcast_to(
                torch.as_tensor(reward, dtype=torch.float32, device=term.device), term.shape),
            terminated=term,
            truncated=trunc,
            info=info,
            prediction_target=(),
        )

    def prediction_target_on_reset(self, old_state, new_state, params):
        return ()
