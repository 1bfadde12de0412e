"""Space specifications for the torch port (counterpart of apx.core.spaces).

Only what the LIDAR and image-classification spaces use is ported:
``Box``, ``Discrete``, ``Image``, ``Logit``, ``DictSpace`` and the
``ActivePerceptionActionSpace`` that ``APEnv.action_space`` builds. Spaces
are hashable descriptions; sampling takes an explicit ``torch.Generator``
and device instead of a JAX key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

__all__ = [
    "Space",
    "Box",
    "Discrete",
    "DictSpace",
    "Image",
    "Logit",
    "ActivePerceptionActionSpace",
]


class Space:
    """Base class for space specs."""

    def sample(self, generator: torch.Generator | None, batch_shape=(), device="cpu"):
        raise NotImplementedError

    def zeros(self, batch_shape=(), device="cpu"):
        raise NotImplementedError

    def contains(self, x) -> bool:
        raise NotImplementedError


def _shape_tuple(shape) -> tuple[int, ...]:
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


@dataclasses.dataclass(frozen=True)
class Box(Space):
    """Continuous box with scalar (broadcast) bounds."""

    low: float = -np.inf
    high: float = np.inf
    shape: tuple[int, ...] = ()
    dtype: Any = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "shape", _shape_tuple(self.shape))

    @property
    def low_arr(self) -> np.ndarray:
        return np.broadcast_to(np.float32(self.low), self.shape)

    @property
    def high_arr(self) -> np.ndarray:
        return np.broadcast_to(np.float32(self.high), self.shape)

    def sample(self, generator, batch_shape=(), device="cpu"):
        """Uniform on the box (the ported spaces are all bounded)."""
        if not (np.isfinite(self.low) and np.isfinite(self.high)):
            raise NotImplementedError("sampling an unbounded Box is not ported")
        shape = (*_shape_tuple(batch_shape), *self.shape)
        u = torch.rand(shape, generator=generator, device=device, dtype=self.dtype)
        return u * (float(self.high) - float(self.low)) + float(self.low)

    def zeros(self, batch_shape=(), device="cpu"):
        z = torch.zeros((*_shape_tuple(batch_shape), *self.shape), dtype=self.dtype, device=device)
        return z.clamp(float(self.low), float(self.high))

    def contains(self, x) -> bool:
        x = torch.as_tensor(x).detach().cpu().numpy()
        return x.shape == self.shape and bool(
            np.all(x >= self.low_arr - 1e-6) and np.all(x <= self.high_arr + 1e-6)
        )


@dataclasses.dataclass(frozen=True)
class Discrete(Space):
    """Integers {0, ..., n - 1}, one per batch element."""

    n: int
    dtype: Any = torch.int32

    @property
    def shape(self) -> tuple[int, ...]:
        return ()

    def sample(self, generator, batch_shape=(), device="cpu"):
        return torch.randint(0, self.n, _shape_tuple(batch_shape), generator=generator,
                             device=device, dtype=self.dtype)

    def zeros(self, batch_shape=(), device="cpu"):
        return torch.zeros(_shape_tuple(batch_shape), dtype=self.dtype, device=device)

    def contains(self, x) -> bool:
        x = torch.as_tensor(x)
        return x.ndim == 0 and 0 <= int(x) < self.n


class _FrozenDict(dict):
    def __hash__(self):  # type: ignore[override]
        return hash(tuple(sorted(self.items(), key=lambda kv: kv[0])))


@dataclasses.dataclass(frozen=True)
class DictSpace(Space):
    spaces: Mapping[str, Space] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "spaces", _FrozenDict(self.spaces))

    def __getitem__(self, key: str) -> Space:
        return self.spaces[key]

    def keys(self):
        return self.spaces.keys()

    def items(self):
        return self.spaces.items()

    def sample(self, generator, batch_shape=(), device="cpu"):
        return {n: s.sample(generator, batch_shape, device) for n, s in self.spaces.items()}

    def zeros(self, batch_shape=(), device="cpu"):
        return {n: s.zeros(batch_shape, device) for n, s in self.spaces.items()}

    def contains(self, x) -> bool:
        return isinstance(x, Mapping) and set(x.keys()) == set(self.spaces.keys()) and all(
            self.spaces[k].contains(v) for k, v in x.items()
        )


@dataclasses.dataclass(frozen=True)
class Image(Box):
    """(..., H, W, C) float image box (ap_gym.ImageSpace conventions)."""

    @staticmethod
    def create(width: int, height: int, channels: int, low: float = 0.0,
               high: float = 1.0) -> "Image":
        return Image(low=low, high=high, shape=(height, width, channels))

    @property
    def height(self) -> int:
        return self.shape[-3]

    @property
    def width(self) -> int:
        return self.shape[-2]

    @property
    def channels(self) -> int:
        return self.shape[-1]


@dataclasses.dataclass(frozen=True)
class Logit(Box):
    """Box tagged as holding unnormalized logits (ap_gym.LogitSpace)."""


@dataclasses.dataclass(frozen=True)
class ActivePerceptionActionSpace(DictSpace):
    """Dict space {"action": inner, "prediction": pred}."""

    @staticmethod
    def create(inner_action_space: Space, prediction_space: Space) -> "ActivePerceptionActionSpace":
        return ActivePerceptionActionSpace(
            spaces={"action": inner_action_space, "prediction": prediction_space}
        )

    @property
    def inner_action_space(self) -> Space:
        return self.spaces["action"]

    @property
    def prediction_space(self) -> Space:
        return self.spaces["prediction"]
