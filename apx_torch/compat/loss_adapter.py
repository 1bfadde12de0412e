"""Reference-shaped LossFn facade (counterpart of apx.compat.loss_adapter).

The reference exposes loss functions with ``numpy``/``torch``/``jax``
methods of signature ``fn(prediction, target, batch_shape=()) -> array``
plus ``lower_bound`` / ``blind_guessing_expected_value`` / ``.normalized``
(loss_fn.py:25-83). This facade gives the port's losses that surface:

* ``numpy`` is the loss's host form, bitwise apx's ``LossFn.numpy``;
* ``torch`` is the port's own ``__call__`` on tensors, in the reference's
  rounding: the sum of squares of an MSE is taken unfused, as
  ``torch.mean`` takes it (the env path contracts it, as XLA does at
  LIDAR's site), so it is bitwise apx's ``LossFn.torch`` on the CPU;
* ``jax`` raises ``NotImplementedError``: the port imports no JAX.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.losses import AffineLossFn, LossFn, MSELossFn, WeightedLossFn, ZeroLossFn

__all__ = ["CompatLossFn"]


def _reference_rounding(loss: LossFn) -> LossFn:
    """``loss`` with every MSE's sum of squares unfused."""
    if isinstance(loss, MSELossFn):
        return dataclasses.replace(loss, fused_sum=False)
    if isinstance(loss, (AffineLossFn, WeightedLossFn)):
        return dataclasses.replace(loss, inner=_reference_rounding(loss.inner))
    return loss


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and len(tree) == 0:
        return tree
    return torch.as_tensor(tree)


class CompatLossFn:
    def __init__(self, loss: LossFn):
        self._loss = loss
        self._torch_loss = _reference_rounding(loss)

    def __call__(self, prediction, target, batch_shape=()):
        return self.numpy(prediction, target, batch_shape)

    def numpy(self, prediction, target, batch_shape=()):
        if isinstance(self._loss, ZeroLossFn):
            return self._loss.numpy(prediction, target, batch_shape)
        return self._loss.numpy(prediction, target)

    def jax(self, prediction, target, batch_shape=()):
        raise NotImplementedError(
            "apx_torch imports no JAX: use .torch or .numpy (or apx.compat for a jax loss)"
        )

    def torch(self, prediction, target, batch_shape=()):
        prediction, target = _tensors(prediction), _tensors(target)
        if isinstance(self._loss, ZeroLossFn):
            return self._loss(prediction, target, batch_shape)
        return self._torch_loss(prediction, target)

    @property
    def lower_bound(self):
        return self._loss.lower_bound

    @property
    def blind_guessing_expected_value(self):
        return self._loss.blind_guessing_expected_value

    @property
    def normalized(self):
        return CompatLossFn(self._loss.normalized)

    @property
    def inner(self):
        return self._loss
