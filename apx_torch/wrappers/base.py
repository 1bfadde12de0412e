"""Forwarding wrapper base (counterpart of apx.wrappers.base)."""

from __future__ import annotations

from ..core.env import APEnv, APStepResult
from ..core.losses import LossFn
from ..core.spaces import Space

__all__ = ["APWrapper"]


class APWrapper(APEnv):
    """Re-exposes the inner env's spaces, loss and dynamics; subclasses
    override what they change."""

    def __init__(self, env: APEnv):
        self.env = env

    def default_params(self, **overrides):
        return self.env.default_params(**overrides)

    def observation_space(self, params) -> Space:
        return self.env.observation_space(params)

    def inner_action_space(self, params) -> Space:
        return self.env.inner_action_space(params)

    def prediction_space(self, params) -> Space:
        return self.env.prediction_space(params)

    def prediction_target_space(self, params) -> Space:
        return self.env.prediction_target_space(params)

    def loss_fn(self, params) -> LossFn:
        return self.env.loss_fn(params)

    def draw_reset(self, num_envs, params, generator):
        return self.env.draw_reset(num_envs, params, generator)

    def reset_from_draws(self, draws, params):
        return self.env.reset_from_draws(draws, params)

    def autoreset_from_draws(self, draws, old_state, params, only=None):
        return self.env.autoreset_from_draws(draws, old_state, params, only=only)

    def draw_step(self, num_envs, params, generator):
        return self.env.draw_step(num_envs, params, generator)

    def step_env(self, state, action, prediction, params, draws=None) -> APStepResult:
        return self.env.step_env(state, action, prediction, params, draws)

    def wrap_reset(self, obs, state, info, params):
        """Lift an inner batched reset result through this wrapper (used to
        build wrapped states from host draws, compat.builders)."""
        return obs, state, info

    def obs_derived_from_state(self, state, params):
        return self.env.obs_derived_from_state(state, params)

    def prediction_target_on_reset(self, old_state, new_state, params):
        return self.env.prediction_target_on_reset(old_state, new_state, params)
