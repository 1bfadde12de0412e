"""The gymnasium shells of the drop-in adapter (counterpart of
apx.compat.gym_env's classes).

``GymVectorAPEnv`` is a real ``gym.vector.VectorEnv`` and ``GymAPEnv`` a
real ``gym.Env`` (foreign wrappers isinstance-check them). They hold the
gymnasium spaces, ``metadata``, ``spec``, ``loss_fn``, ``render`` and
``close``, and delegate reset and step to the gymnasium-free core,
``adapter.VectorAdapter``. This module imports gymnasium.
"""

from __future__ import annotations

from typing import Any

import gymnasium as gym
import numpy as np

from .adapter import VectorAdapter
from .spaces import to_gym_action_space, to_gym_space

__all__ = ["GymVectorAPEnv", "GymAPEnv"]


def _squeeze_tree(tree):
    """Env 0 of every array leaf (dicts, tuples and lists are containers,
    as in a pytree; the masked prediction's ``()`` stays empty)."""
    if isinstance(tree, dict):
        return {k: _squeeze_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_squeeze_tree(v) for v in tree)
    if tree is None:
        return None
    return np.asarray(tree)[0]


class GymVectorAPEnv(gym.vector.VectorEnv):
    """Vectorized gymnasium-style adapter exposing the reference's
    loss_fn/prediction spaces. Arguments as ``VectorAdapter``'s."""

    metadata = {
        "autoreset_mode": "NextStep",
        "render_modes": ["rgb_array"],
        "render_fps": 4,
    }
    render_mode = "rgb_array"

    def __init__(self, env, params, num_envs: int, autoreset: str = "lockstep",
                 rng: str = "reference", sparse: bool = False, key_impl: str | None = None):
        self.core = VectorAdapter(env, params, num_envs, autoreset=autoreset, rng=rng,
                                  sparse=sparse, key_impl=key_impl)
        self.env = env
        self.num_envs = num_envs

        # Spaces (reference naming: single_* and batched).
        self.single_observation_space = to_gym_space(env.observation_space(params))
        self.single_action_space = to_gym_action_space(env, params)
        self.single_inner_action_space = to_gym_space(env.inner_action_space(params))
        self.single_prediction_space = to_gym_space(env.prediction_space(params))
        self.single_prediction_target_space = to_gym_space(
            env.prediction_target_space(params)
        )
        self.observation_space = gym.vector.utils.batch_space(
            self.single_observation_space, num_envs
        )
        self.action_space = gym.vector.utils.batch_space(self.single_action_space, num_envs)
        # Batched accessors, like BaseActivePerceptionVectorEnv's properties
        # (active_perception_vector_env.py:52-66).
        self.inner_action_space = self.action_space["action"]
        self.prediction_space = self.action_space["prediction"]
        self.prediction_target_space = gym.vector.utils.batch_space(
            self.single_prediction_target_space, num_envs
        )

    @property
    def params(self):
        return self.core.params

    @property
    def loss_fn(self):
        # Cached: the reference stores loss_fn as an attribute, so repeated
        # accesses are identity-stable (user code compares/holds it).
        if getattr(self, "_compat_loss", None) is None:
            from .loss_adapter import CompatLossFn

            self._compat_loss = CompatLossFn(self.core.loss)
        return self._compat_loss

    def reset(self, *, seed: int | None = None, options: dict | None = None):
        return self.core.reset(seed=seed, options=options)

    def step(self, actions: dict[str, Any]):
        return self.core.step(actions)

    def render(self):
        return self.core.render()

    def close(self, **kwargs):
        if hasattr(self, "core"):  # gymnasium's __del__ closes half-built envs too
            self.core.close()


class GymAPEnv(gym.Env):
    """Single-env gymnasium-style adapter: a squeezed 1-env vector adapter,
    mirroring the reference's VectorToSingleWrapper construction for image
    envs and plain envs for the rest."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": 4}
    render_mode = "rgb_array"
    spec = None

    def __init__(self, env=None, params=None, autoreset="lockstep", rng="reference",
                 sparse=False, vec=None, key_impl=None):
        self._vec = vec if vec is not None else GymVectorAPEnv(
            env, params, num_envs=1, autoreset=autoreset, rng=rng, sparse=sparse,
            key_impl=key_impl,
        )
        assert self._vec.num_envs == 1
        self.observation_space = self._vec.single_observation_space
        self.action_space = self._vec.single_action_space
        self.inner_action_space = self._vec.single_inner_action_space
        self.prediction_space = self._vec.single_prediction_space
        self.prediction_target_space = self._vec.single_prediction_target_space

    @property
    def loss_fn(self):
        return self._vec.loss_fn

    @property
    def env(self):
        return self._vec.env

    @property
    def params(self):
        return self._vec.params

    def reset(self, *, seed: int | None = None, options: dict | None = None):
        obs, info = self._vec.reset(seed=seed, options=options)
        return _squeeze_tree(obs), _squeeze_tree(info)

    def step(self, action: dict[str, Any]):
        def lift(x):
            # Values are array-likes (incl. plain Python lists); () is the
            # masked-prediction sentinel and stays empty.
            if isinstance(x, tuple) and len(x) == 0:
                return x
            if isinstance(x, dict):
                return {k: lift(v) for k, v in x.items()}
            return np.asarray(x)[None]

        batched = {k: lift(v) for k, v in action.items()}
        obs, reward, term, trunc, info = self._vec.step(batched)
        return (
            _squeeze_tree(obs),
            float(reward[0]),
            bool(term[0]),
            bool(trunc[0]),
            _squeeze_tree(info),
        )

    def render(self):
        return self._vec.render()

    def close(self):
        pass
