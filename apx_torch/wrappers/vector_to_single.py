"""Run a 1-env vector pipeline as a single env (counterpart of
apx.wrappers.vector_to_single): inputs gain a leading axis of 1, outputs
lose it. Needed for vector-level wrappers whose semantics live above the
autoreset layer; apx builds its single HideAndSeek env this way.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.env import tree_map

__all__ = ["VectorToSingle"]


def _squeeze0(tree):
    return tree_map(lambda x: x[0], tree)


def _unsqueeze0(tree):
    return tree_map(lambda x: x[None], tree)


@dataclasses.dataclass(frozen=True)
class VectorToSingle:
    """Wraps any ``VectorAPEnv``-like object with ``num_envs == 1``. The
    state stays the vector env's; obs, rewards, dones and info are
    squeezed, the action and injected draws unsqueezed."""

    vec: Any

    def __post_init__(self):
        if self.vec.num_envs != 1:
            raise ValueError(f"VectorToSingle requires num_envs == 1, got {self.vec.num_envs}")

    @property
    def env(self):
        return self.vec.env

    def _spaces_source(self, name: str):
        """The vector wrapper where it defines ``name`` (HideAndSeek's
        masked spaces and zero loss), else the inner env, as apx does."""
        return self.vec if hasattr(self.vec, name) else self.vec.env

    def inner_action_space(self, params):
        return self._spaces_source("inner_action_space").inner_action_space(params)

    def prediction_space(self, params):
        return self._spaces_source("prediction_space").prediction_space(params)

    def loss_fn(self, params):
        return self._spaces_source("loss_fn").loss_fn(params)

    def reset(self, params, generator: torch.Generator | None = None, draws=None):
        obs, state, info = self.vec.reset(params, generator, draws=_unsqueeze0(draws))
        return _squeeze0(obs), state, _squeeze0(info)

    def step(self, state, full_action: dict[str, Any], params,
             generator: torch.Generator | None = None, reset_draws=None, step_draws=None):
        obs, state2, reward, term, trunc, info = self.vec.step(
            state, _unsqueeze0(full_action), params, generator,
            reset_draws=_unsqueeze0(reset_draws), step_draws=_unsqueeze0(step_draws))
        return _squeeze0(obs), state2, reward[0], term[0], trunc[0], _squeeze0(info)
