"""Port Space -> gymnasium space conversion for the compat layer
(counterpart of apx.compat.spaces; gymnasium is imported inside).

Mirrors the reference's space taxonomy (ImageSpace/LogitSpace are Box
subclasses with metadata, image_space.py:9-62, logit_space.py:4-23).
"""

from __future__ import annotations

import numpy as np

from ..core import spaces as S

__all__ = ["to_gym_space", "to_gym_action_space"]


def to_gym_space(space: S.Space):
    import gymnasium as gym

    if isinstance(space, S.DictSpace):
        return gym.spaces.Dict({k: to_gym_space(v) for k, v in space.spaces.items()})
    if isinstance(space, S.TupleSpace):
        return gym.spaces.Tuple(tuple(to_gym_space(s) for s in space.spaces))
    if isinstance(space, S.Discrete):
        return gym.spaces.Discrete(space.n)
    if isinstance(space, S.MultiDiscrete):
        return gym.spaces.MultiDiscrete(np.asarray(space.nvec))
    if isinstance(space, S.Box):  # covers Image and Logit subclasses
        low = np.broadcast_to(np.asarray(space.low, np.float32), space.shape)
        high = np.broadcast_to(np.asarray(space.high, np.float32), space.shape)
        return gym.spaces.Box(low=low, high=high, shape=space.shape, dtype=np.float32)
    raise TypeError(f"Cannot convert space {space!r}")


def to_gym_action_space(env, params):
    import gymnasium as gym

    return gym.spaces.Dict(
        {
            "action": to_gym_space(env.inner_action_space(params)),
            "prediction": to_gym_space(env.prediction_space(params)),
        }
    )
