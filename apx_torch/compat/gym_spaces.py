"""Gymnasium space subclasses for the compat class layer (counterpart of
apx.compat.gym_spaces).

The reference tags some spaces with subclass identity — the composite
action space (active_perception_env.py:27-68), image boxes
(image_space.py:9-62) and logit boxes (logit_space.py:4-23) — and relies
on custom ``gym.vector.utils.batch_space`` registrations so that identity
survives vectorization. This module provides the same three space types
for the port's drop-in class layer (``apx_torch.compat.gym_classes``); the
device path uses the functional specs in ``apx_torch.core.spaces``
instead. It imports gymnasium.
"""

from __future__ import annotations

import gymnasium as gym
import numpy as np

__all__ = ["ActivePerceptionActionSpace", "ImageSpace", "LogitSpace"]


class ActivePerceptionActionSpace(gym.spaces.Dict):
    """The composite ``{"action", "prediction"}`` Dict space.

    Behavioral spec: active_perception_env.py:27-68 — a Dict subclass whose
    identity is preserved under ``batch_space`` (registration below), with
    accessors for the two halves and Dict round-trip helpers.
    """

    def __init__(self, inner_action_space, prediction_space, seed=None):
        super().__init__(
            {"action": inner_action_space, "prediction": prediction_space},
            seed=seed,
        )

    inner_action_space = property(lambda self: self["action"])
    prediction_space = property(lambda self: self["prediction"])

    @property
    def as_dict(self) -> gym.spaces.Dict:
        """A plain Dict view sharing this space's RNG."""
        return gym.spaces.Dict(dict(self.spaces), seed=self._np_random)

    @classmethod
    def from_dict(cls, d: gym.spaces.Dict) -> "ActivePerceptionActionSpace":
        """Re-tag a two-key Dict (e.g. one produced by batch_space)."""
        return cls(d["action"], d["prediction"], seed=d._np_random)


@gym.vector.utils.batch_space.register(ActivePerceptionActionSpace)
def _batch_ap_action_space(space: ActivePerceptionActionSpace, n: int = 1):
    # Batch the plain-Dict view, then re-tag the result so vectorized envs
    # still expose an ActivePerceptionActionSpace (reference :62-68).
    return ActivePerceptionActionSpace.from_dict(
        gym.vector.utils.batch_space(space.as_dict, n)
    )


class ImageSpace(gym.spaces.Box):
    """Box with (..., H, W, C) image convention and the reference's ctor
    signature ImageSpace(width, height, channels, batch_shape=(), ...)
    (image_space.py:9-62)."""

    def __init__(
        self,
        width: int,
        height: int,
        channels: int,
        batch_shape: tuple = (),
        dtype=np.float32,
        seed=None,
        low=0.0,
        high=1.0,
    ):
        super().__init__(
            low, high, (*batch_shape, height, width, channels), dtype, seed
        )

    @classmethod
    def from_box(cls, box: gym.spaces.Box):
        return cls(
            box.shape[-2], box.shape[-3], box.shape[-1], box.shape[:-3],
            box.dtype, box.np_random, box.low, box.high,
        )

    @property
    def height(self) -> int:
        return self.shape[-3]

    @property
    def width(self) -> int:
        return self.shape[-2]

    @property
    def channels(self) -> int:
        return self.shape[-1]

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return self.shape[:-3]


@gym.vector.utils.batch_space.register(ImageSpace)
def _batch_image_space(space: ImageSpace, n: int = 1):
    return ImageSpace.from_box(
        gym.spaces.Box(
            low=np.broadcast_to(space.low, (n, *space.shape)).copy(),
            high=np.broadcast_to(space.high, (n, *space.shape)).copy(),
            dtype=space.dtype,
        )
    )


class LogitSpace(gym.spaces.Box):
    """Box tagging unbounded logit vectors (logit_space.py:4-23)."""


@gym.vector.utils.batch_space.register(LogitSpace)
def _batch_logit_space(space: LogitSpace, n: int = 1):
    return LogitSpace(
        low=np.broadcast_to(space.low, (n, *space.shape)).copy(),
        high=np.broadcast_to(space.high, (n, *space.shape)).copy(),
        shape=(n, *space.shape),
        dtype=space.dtype,
    )
