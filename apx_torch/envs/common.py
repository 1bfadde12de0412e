"""Shared task-family helpers (counterpart of apx.envs.common)."""

from __future__ import annotations

import logging

import numpy as np

from ..core.losses import LossFn, MSELossFn
from ..core.spaces import Box

logger = logging.getLogger(__name__)

__all__ = ["make_regression_loss_and_target_space"]


def make_regression_loss_and_target_space(
    target_dim: int,
    prediction_low: float = -np.inf,
    prediction_high: float = np.inf,
    target_std: float | None = None,
    fused_sum: bool = True,
    contract_reward: bool = False,
) -> tuple[LossFn, Box]:
    """MSE loss (normalized if bounds are finite, assuming a uniform target
    distribution: std = (high - low)/sqrt(12)) and the Box target space.
    ``fused_sum``, ``contract_reward``: see ``MSELossFn``."""
    target_space = Box(low=prediction_low, high=prediction_high, shape=(target_dim,))
    if target_std is None and np.isfinite(prediction_low) and np.isfinite(prediction_high):
        target_std = float((prediction_high - prediction_low) / np.sqrt(12))
    loss: LossFn = MSELossFn(target_std=target_std, fused_sum=fused_sum,
                             contract_reward=contract_reward)
    if target_std is not None:
        loss = loss.normalized
    else:
        logger.warning(
            "Prediction target space is unbounded, and target_std is not provided. "
            "MSE loss will not be normalized."
        )
    return loss, target_space
