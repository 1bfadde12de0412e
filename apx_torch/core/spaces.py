"""Space specifications for the torch port (counterpart of apx.core.spaces).

``Box`` (scalar or array bounds), ``Discrete``, ``MultiDiscrete``,
``TupleSpace``, ``DictSpace``, ``Image``, ``Logit``, the
``ActivePerceptionActionSpace`` that ``APEnv.action_space`` builds, and
``batch_space``. Spaces are hashable descriptions; sampling takes an
explicit ``torch.Generator`` instead of a JAX key, and lands on the
generator's device unless a device is given.
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
    "MultiDiscrete",
    "TupleSpace",
    "ActivePerceptionActionSpace",
    "batch_space",
]


class Space:
    """Base class for space specs."""

    def sample(self, generator: torch.Generator | None, batch_shape=(), device=None):
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


def _device(generator, device):
    """``device``, else the generator's, else the CPU."""
    if device is not None:
        return torch.device(device)
    return generator.device if generator is not None else torch.device("cpu")


def _to_nested_tuple(a: np.ndarray):
    if a.ndim == 0:
        return a.item()
    return tuple(_to_nested_tuple(x) for x in a)


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64, torch.int32: np.int32,
              torch.int64: np.int64, torch.uint8: np.uint8}


@dataclasses.dataclass(frozen=True)
class Box(Space):
    """Continuous box. ``low``/``high`` are scalars (broadcast) or array
    bounds, stored as nested tuples so the space stays hashable."""

    low: Any = -np.inf
    high: Any = np.inf
    shape: tuple[int, ...] = ()
    dtype: Any = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "shape", _shape_tuple(self.shape))
        for name in ("low", "high"):
            v = getattr(self, name)
            if isinstance(v, (np.ndarray, list, tuple, torch.Tensor)):
                object.__setattr__(self, name, _to_nested_tuple(np.asarray(v)))

    @property
    def low_arr(self) -> np.ndarray:
        return np.broadcast_to(np.asarray(self.low, dtype=_NP_DTYPES[self.dtype]), self.shape)

    @property
    def high_arr(self) -> np.ndarray:
        return np.broadcast_to(np.asarray(self.high, dtype=_NP_DTYPES[self.dtype]), self.shape)

    def sample(self, generator, batch_shape=(), device=None):
        """gymnasium's rule per element (apx/core/spaces.py:88-115):
        uniform where both bounds are finite, standard normal where neither
        is, and ``bound +- exponential`` where one is."""
        dev = _device(generator, device)
        shape = (*_shape_tuple(batch_shape), *self.shape)
        low, high = self.low_arr.astype(np.float32), self.high_arr.astype(np.float32)
        lo_fin, hi_fin = np.isfinite(low), np.isfinite(high)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        lo0, hi0 = t(np.where(lo_fin, low, 0.0)), t(np.where(hi_fin, high, 0.0))
        out = torch.rand(shape, generator=generator, device=dev) * (hi0 - lo0) + lo0
        if not (lo_fin & hi_fin).all():
            normal = torch.randn(shape, generator=generator, device=dev)
            exp = torch.empty(shape, device=dev).exponential_(generator=generator)
            tail = torch.where(t(lo_fin), lo0 + exp, hi0 - exp)
            out = torch.where(t(lo_fin & hi_fin), out, torch.where(t(lo_fin | hi_fin), tail, normal))
        return out.to(self.dtype)

    def zeros(self, batch_shape=(), device="cpu"):
        z = torch.zeros((*_shape_tuple(batch_shape), *self.shape), dtype=self.dtype, device=device)
        low = torch.from_numpy(np.ascontiguousarray(self.low_arr)).to(device)
        high = torch.from_numpy(np.ascontiguousarray(self.high_arr)).to(device)
        return torch.minimum(torch.maximum(z, low), high)

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

    def sample(self, generator, batch_shape=(), device=None):
        return torch.randint(0, self.n, _shape_tuple(batch_shape), generator=generator,
                             device=_device(generator, device), dtype=self.dtype)

    def zeros(self, batch_shape=(), device="cpu"):
        return torch.zeros(_shape_tuple(batch_shape), dtype=self.dtype, device=device)

    def contains(self, x) -> bool:
        x = torch.as_tensor(x)
        return x.ndim == 0 and 0 <= int(x) < self.n


@dataclasses.dataclass(frozen=True)
class MultiDiscrete(Space):
    """Integers {0, ..., nvec[i] - 1} along one trailing axis."""

    nvec: tuple[int, ...]
    dtype: Any = torch.int32

    def __post_init__(self):
        object.__setattr__(self, "nvec", tuple(int(n) for n in self.nvec))

    @property
    def shape(self) -> tuple[int, ...]:
        return (len(self.nvec),)

    def sample(self, generator, batch_shape=(), device=None):
        dev = _device(generator, device)
        shape = (*_shape_tuple(batch_shape), len(self.nvec))
        u = torch.rand(shape, generator=generator, device=dev, dtype=torch.float64)
        n = torch.tensor(self.nvec, dtype=torch.float64, device=dev)
        return torch.minimum(torch.floor(u * n), n - 1).to(self.dtype)

    def zeros(self, batch_shape=(), device="cpu"):
        return torch.zeros((*_shape_tuple(batch_shape), len(self.nvec)), dtype=self.dtype,
                           device=device)

    def contains(self, x) -> bool:
        x = torch.as_tensor(x).detach().cpu().numpy()
        return x.shape == self.shape and bool(np.all(x >= 0) and np.all(x < np.asarray(self.nvec)))


@dataclasses.dataclass(frozen=True)
class TupleSpace(Space):
    spaces: tuple[Space, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "spaces", tuple(self.spaces))

    def sample(self, generator, batch_shape=(), device=None):
        return tuple(s.sample(generator, batch_shape, device) for s in self.spaces)

    def zeros(self, batch_shape=(), device="cpu"):
        return tuple(s.zeros(batch_shape, device) for s in self.spaces)

    def contains(self, x) -> bool:
        return (isinstance(x, (tuple, list)) and len(x) == len(self.spaces)
                and all(s.contains(v) for s, v in zip(self.spaces, x)))


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

    def sample(self, generator, batch_shape=(), device=None):
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


def batch_space(space: Space, n: int) -> Space:
    """Prepend a batch axis of size n (apx/core/spaces.py:301-324): boxes
    broadcast array bounds, ``Discrete`` becomes ``MultiDiscrete``,
    ``MultiDiscrete`` a box of its largest range."""
    if isinstance(space, ActivePerceptionActionSpace):
        return ActivePerceptionActionSpace(
            spaces={k: batch_space(v, n) for k, v in space.spaces.items()})
    if isinstance(space, Box):
        def bound(b):
            return b if np.isscalar(b) else np.broadcast_to(np.asarray(b), (n, *space.shape))

        return type(space)(low=bound(space.low), high=bound(space.high), shape=(n, *space.shape),
                           dtype=space.dtype)
    if isinstance(space, Discrete):
        return MultiDiscrete(nvec=(space.n,) * n, dtype=space.dtype)
    if isinstance(space, MultiDiscrete):
        return Box(low=0, high=max(space.nvec) - 1, shape=(n, *space.shape), dtype=space.dtype)
    if isinstance(space, TupleSpace):
        return TupleSpace(spaces=tuple(batch_space(s, n) for s in space.spaces))
    if isinstance(space, DictSpace):
        return DictSpace(spaces={k: batch_space(v, n) for k, v in space.spaces.items()})
    raise TypeError(f"Cannot batch space {space!r}")
