"""Differentiable prediction losses (counterpart of apx.core.losses).

Ported: ``LossFn`` with ``.normalized``, ``AffineLossFn``, ``MSELossFn``
(the regression envs), ``CrossEntropyLossFn`` (the classification envs),
``WeightedLossFn`` (the sparse ids), ``ZeroLossFn`` (pseudo AP envs) and
``LambdaLossFn`` (a torch callable, and optionally a numpy one). Each loss
is a frozen dataclass; ``__call__(prediction, target)`` takes torch tensors
and reduces the trailing feature axis. ``numpy(prediction, target)`` is
apx's host form, op for op: the gymnasium adapter (``apx_torch.compat``)
composes its rewards with it, bitwise apx.compat's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .numerics import div, fma, sum_squares

__all__ = ["LossFn", "AffineLossFn", "MSELossFn", "CrossEntropyLossFn", "WeightedLossFn",
           "ZeroLossFn", "LambdaLossFn", "MSETerms", "mse_terms", "masked_loss_and_reward"]


@dataclasses.dataclass(frozen=True)
class LossFn:
    """Base loss: loss(prediction, target) -> batch-shaped tensor."""

    def __call__(self, prediction, target):
        raise NotImplementedError

    def numpy(self, prediction, target):
        """Host numpy form of the loss (apx's ``LossFn.numpy``)."""
        raise NotImplementedError

    def reward(self, base_reward, loss, prediction, target):
        """``base_reward - loss`` (``loss`` is this function's value), as
        the jitted reference rounds the env's reward."""
        return base_reward - loss

    @property
    def lower_bound(self) -> float:
        return -np.inf

    @property
    def blind_guessing_expected_value(self) -> float | None:
        return None

    @property
    def normalized(self) -> "AffineLossFn":
        upper = self.blind_guessing_expected_value
        if upper is None:
            raise ValueError(
                "Cannot normalize loss function without blind guessing expected value."
            )
        lower = self.lower_bound
        if upper <= lower:
            raise ValueError(
                "Cannot normalize loss function when blind guessing expected value "
                "is not greater than lower bound."
            )
        scale = 1.0 / (upper - lower)
        return AffineLossFn(inner=self, scale=scale, offset=-lower * scale)


@dataclasses.dataclass(frozen=True)
class AffineLossFn(LossFn):
    """inner * scale + offset. JAX rounds the Python-float ``scale`` and
    ``offset`` to float32 before the multiply; so does this."""

    inner: LossFn = None  # type: ignore[assignment]
    scale: float = 1.0
    offset: float = 0.0

    def __call__(self, prediction, target):
        scale = float(np.float32(self.scale))
        offset = float(np.float32(self.offset))
        return self.inner(prediction, target) * scale + offset

    def numpy(self, prediction, target):
        """``scale`` and ``offset`` unrounded, as apx's host form: a float64
        scale (the cross-entropy's) makes the result float64."""
        return self.inner.numpy(prediction, target) * self.scale + self.offset

    def reward(self, base_reward, loss, prediction, target):
        """Over an ``MSELossFn(contract_reward=True)`` with no offset: XLA
        folds the mean's ``1 / D`` and the scale into one constant and
        contracts the product into the reward's subtraction,
        ``fma(-sum((p - t)^2), f32(1 / D) * f32(scale), base_reward)``
        (the same value as the loss's rounding only when D is a power of
        two, as at the localization envs' site, D = 2)."""
        inner = self.inner
        if not (isinstance(inner, MSELossFn) and inner.contract_reward and self.offset == 0.0):
            return base_reward - loss
        diff = prediction - target
        total = inner.sum_of_squares(diff)
        k = float(np.float32(1.0) / np.float32(diff.shape[-1]) * np.float32(self.scale))
        return fma(total, -k, base_reward)

    @property
    def lower_bound(self) -> float:
        return self.inner.lower_bound * self.scale + self.offset

    @property
    def blind_guessing_expected_value(self) -> float | None:
        v = self.inner.blind_guessing_expected_value
        return None if v is None else v * self.scale + self.offset


@dataclasses.dataclass(frozen=True)
class MSELossFn(LossFn):
    """mean((prediction - target)^2, axis=-1), with the sum of squares
    rounded as the jitted reference rounds it at the env's call site: one
    FMA per further element (``numerics.sum_squares``) where XLA-CPU
    contracts the reduce (LIDAR), each square rounded where it does not
    (LightDark and the localization envs, whose reduce XLA vectorises).
    ``contract_reward``: the normalized loss's product is contracted into
    the reward (``AffineLossFn.reward``; the localization envs)."""

    target_std: float | tuple[float, ...] | None = None
    fused_sum: bool = True
    contract_reward: bool = False

    def sum_of_squares(self, diff):
        return sum_squares(diff) if self.fused_sum else (diff * diff).sum(dim=-1)

    def __call__(self, prediction, target):
        diff = prediction - target
        return div(self.sum_of_squares(diff), diff.shape[-1])

    def numpy(self, prediction, target):
        return np.mean((np.asarray(prediction) - np.asarray(target)) ** 2, axis=-1)

    @property
    def lower_bound(self) -> float:
        return 0.0

    @property
    def blind_guessing_expected_value(self) -> float | None:
        if self.target_std is None:
            return None
        return float(np.mean(np.asarray(self.target_std) ** 2))


@dataclasses.dataclass(frozen=True)
class CrossEntropyLossFn(LossFn):
    """-log_softmax(prediction)[target] over the last axis.

    The label is picked with a one-hot select-reduce, as apx does (its
    gather-free form), not a gather: the select adds exact zeros around the
    picked log-probability, so the value is the gather's except that a
    log-probability of exactly -0.0 comes out as -0.0 where the gather
    gives +0.0 — the same sign apx gives. Labels must be in [0, C)."""

    num_classes: int | None = None

    def __call__(self, prediction, target):
        logp = torch.log_softmax(prediction, dim=-1)
        classes = torch.arange(logp.shape[-1], device=logp.device)
        onehot = classes == target[..., None].to(torch.int64)
        return -torch.where(onehot, logp, 0.0).sum(dim=-1)

    def numpy(self, prediction, target):
        import scipy.special

        logp = scipy.special.log_softmax(prediction, axis=-1)
        return -np.take_along_axis(logp, np.asarray(target)[..., None], axis=-1)[..., 0]

    @property
    def lower_bound(self) -> float:
        return 0.0

    @property
    def blind_guessing_expected_value(self) -> float | None:
        """A numpy float64 scalar, as apx's: it makes the normalized loss's
        host form float64, as in the reference."""
        if self.num_classes is None:
            return None
        return np.log(self.num_classes)


@dataclasses.dataclass(frozen=True)
class WeightedLossFn(LossFn):
    """Target {"target", "weight"}: ``inner(prediction, target) * weight``
    (the sparse ids, where weight = terminated; apx/core/losses.py:260-294)."""

    inner: LossFn = None  # type: ignore[assignment]
    min_weight: float = 0.0
    average_weight: float | None = None

    def __call__(self, prediction, target):
        return self.inner(prediction, target["target"]) * target["weight"]

    def numpy(self, prediction, target):
        return self.inner.numpy(prediction, target["target"]) * target["weight"]

    @property
    def lower_bound(self) -> float:
        return self.min_weight * self.inner.lower_bound

    @property
    def blind_guessing_expected_value(self) -> float | None:
        v = self.inner.blind_guessing_expected_value
        if v is None or self.average_weight is None:
            return None
        return self.average_weight * v


@dataclasses.dataclass(frozen=True)
class MSETerms:
    """An MSE loss over D features (``MSELossFn``, or an ``AffineLossFn``
    over one) as float32 constants, the form the fused NEXT_STEP merge
    computes (``ops.merge_cuda``): S = the sum of squares of p - t (one FMA
    per further element when ``fused_sum``, else rounded squares summed),
    loss = S / D, then ``loss * scale + offset`` when ``affine``; reward =
    ``fma(S, -k, base_reward)`` when ``contract``, else ``base_reward -
    loss``."""

    d: int
    fused_sum: bool
    affine: bool
    scale: float
    offset: float
    contract: bool
    k: float


MAX_FUSED_FEATURES = 8  # the kernel's prediction width


def mse_terms(loss_fn: LossFn, d: int) -> MSETerms | None:
    """``loss_fn``'s ``MSETerms`` for predictions of D features, or None
    when it is another loss, or when D is outside what the fused merge
    rounds as PyTorch does (1 <= D <= 8; D <= 2 for rounded squares,
    whose sum PyTorch may reorder beyond two)."""
    inner, affine = loss_fn, isinstance(loss_fn, AffineLossFn)
    if affine:
        inner = loss_fn.inner
    if type(inner) is not MSELossFn or (affine and type(loss_fn) is not AffineLossFn):
        return None
    if not 1 <= d <= (MAX_FUSED_FEATURES if inner.fused_sum else 2):
        return None
    scale = float(np.float32(loss_fn.scale)) if affine else 1.0
    offset = float(np.float32(loss_fn.offset)) if affine else 0.0
    contract = affine and inner.contract_reward and loss_fn.offset == 0.0
    k = float(np.float32(1.0) / np.float32(d) * np.float32(loss_fn.scale)) if contract else 0.0
    return MSETerms(d, inner.fused_sum, affine, scale, offset, contract, k)


def masked_loss_and_reward(loss_fn: LossFn, mask: torch.Tensor, base_reward: torch.Tensor,
                           prediction, target) -> tuple[torch.Tensor, torch.Tensor]:
    """A NEXT_STEP step's loss and reward as ``VectorAPEnv.step`` composes
    them, both 0 where ``mask`` (the envs reset this step):
    ``where(mask, 0, loss)`` and ``where(mask, 0, reward(base_reward,
    masked loss))``; ``base_reward`` is already masked. The plain form of
    the fused merge's loss and reward, and its gradient."""
    loss = torch.where(mask, 0.0, loss_fn(prediction, target))
    reward = torch.where(mask, 0.0, loss_fn.reward(base_reward, loss, prediction, target))
    return loss, reward


def _first_tensor(tree) -> torch.Tensor | None:
    if isinstance(tree, torch.Tensor):
        return tree
    children = tree.values() if isinstance(tree, dict) else tree
    for child in children if isinstance(tree, (dict, tuple, list)) else ():
        found = _first_tensor(child)
        if found is not None:
            return found
    return None


@dataclasses.dataclass(frozen=True)
class ZeroLossFn(LossFn):
    """Constant zero (the pseudo AP envs' loss). Predictions and targets
    may be empty tuples; ``batch_shape`` sets the output's shape. The zeros
    lie on the device of the first tensor in the prediction or target, else
    on the CPU."""

    def __call__(self, prediction, target, batch_shape: tuple[int, ...] = ()):
        leaf = _first_tensor((target, prediction))
        dev = leaf.device if leaf is not None else torch.device("cpu")
        return torch.zeros(batch_shape, dtype=torch.float32, device=dev)

    def numpy(self, prediction, target, batch_shape: tuple[int, ...] = ()):
        return np.zeros(batch_shape, dtype=np.float32)

    @property
    def lower_bound(self) -> float:
        return 0.0

    @property
    def blind_guessing_expected_value(self) -> float:
        return 0.0


@dataclasses.dataclass(frozen=True)
class LambdaLossFn(LossFn):
    """A user's torch callable ``fn(prediction, target)`` as a loss, with
    its bounds and, optionally, its numpy form ``numpy_fn`` (apx's
    LambdaLossFn, whose torch form ``fn`` is)."""

    fn: Callable[[Any, Any], torch.Tensor] = None  # type: ignore[assignment]
    lower_bound_value: float = -np.inf
    blind_guess_value: float | None = None
    numpy_fn: Callable[[Any, Any], np.ndarray] | None = None

    def __call__(self, prediction, target):
        return self.fn(prediction, target)

    def numpy(self, prediction, target):
        if self.numpy_fn is None:
            raise NotImplementedError("Loss function is not implemented for numpy.")
        return self.numpy_fn(prediction, target)

    @property
    def lower_bound(self) -> float:
        return self.lower_bound_value

    @property
    def blind_guessing_expected_value(self) -> float | None:
        return self.blind_guess_value

    def __hash__(self):
        return hash((id(self.fn), id(self.numpy_fn), self.lower_bound_value,
                     self.blind_guess_value))
