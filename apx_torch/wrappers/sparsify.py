"""Sparsify wrapper: the prediction loss counts only on the terminal step
(counterpart of apx.wrappers.sparsify; every ``<Name>-sparse-v0`` id).

* The prediction target becomes ``{"target", "weight": terminated as
  float32}`` and the loss ``WeightedLossFn(inner)``, so the reward is
  ``base_reward - weight * loss``.
* apx's quirk is kept: ``info["prediction"]["loss"]`` reports the DENSE
  inner loss, while the target in info is the weighted dict. That second
  loss runs inside the span ``vector.info_loss``.
"""

from __future__ import annotations

import torch

from ..core.env import APStepResult
from ..core.losses import LossFn, WeightedLossFn
from ..core.spaces import Box, DictSpace, Space
from ..core.trace import span
from .base import APWrapper

__all__ = ["Sparsify"]


class Sparsify(APWrapper):
    def prediction_target_space(self, params) -> Space:
        return DictSpace({
            "target": self.env.prediction_target_space(params),
            "weight": Box(low=0.0, high=1.0, shape=()),
        })

    def loss_fn(self, params) -> LossFn:
        return WeightedLossFn(inner=self.env.loss_fn(params))

    def step_env(self, state, action, prediction, params, draws=None) -> APStepResult:
        r = self.env.step_env(state, action, prediction, params, draws)
        return r.replace(prediction_target={
            "target": r.prediction_target,
            "weight": r.terminated.to(torch.float32),
        })

    def prediction_target_on_reset(self, old_state, new_state, params):
        # A LOCKSTEP reset step reports terminated False: weight 0. The
        # weight is (N,), as every leaf of a batched target must be for the
        # vector layer's masked select.
        inner = self.env.prediction_target_on_reset(old_state, new_state, params)
        return {"target": inner, "weight": torch.zeros(inner.shape[0], dtype=torch.float32,
                                                       device=inner.device)}

    def compose_info(self, info, base_reward, pred_target, loss, prediction, params):
        with span("vector.info_loss"):
            dense = self.env.loss_fn(params)(prediction, pred_target["target"])
        return {
            **info,
            "base_reward": base_reward,
            "prediction": {"target": pred_target, "loss": dense},
        }
