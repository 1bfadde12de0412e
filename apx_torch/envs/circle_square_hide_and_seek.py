"""CircleSquare hide-and-seek, a vector-level reward wrapper (counterpart
of apx.envs.circle_square_hide_and_seek, after ap_gym's
circle_square_catch_or_flee).

* The reward gains ``sign * |glimpse_pos - object_pos_norm|``, with sign
  -1 for a square (seek: stay close) and +1 for a circle (flee).
* ``object_pos_norm`` is the reference's quirky ``(x, y) / lim - 1``, not
  the centred glimpse transform; the object's position and label come from
  the CircleSquare bank index (mixed radix [2, W, H]).
* The wrapper sits above the autoreset layer, so on a LOCKSTEP reset step
  the term is computed from the new episode's object and glimpse position.
* ``mask_prediction=True``: the prediction and target spaces are empty
  tuples and the loss is zero; the inner env is stepped with zero logits,
  the reward is the (augmented) base reward, and ``info["prediction"]
  ["loss"]`` keeps the cross-entropy of those zero logits (a reference
  quirk). Under an inner ``Sparsify`` the empty target sits inside the
  weight dict.

Rounding, as apx's jitted step: ``x / lim - 1`` is ``fma(x, f32(1 / lim),
-1)`` (XLA multiplies by the reciprocal and contracts), the distance is
``sqrt(fma(dy, dy, dx * dx))``, and ``sign * distance + reward`` is exact
in its product (sign is +-1).

It is a frozen dataclass holding the vector env in ``venv``, so
``core.env.with_autoreset`` recurses through it and ``rollout_episodic``
runs it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.env import VectorAPEnv, VectorState
from ..core.losses import ZeroLossFn
from ..core.numerics import fma
from ..core.spaces import TupleSpace
from ..ops.geometry import norm2
from ..ops.glimpse import sensor_pos_lim_pixels

__all__ = ["CircleSquareHideAndSeek"]


@dataclasses.dataclass(frozen=True)
class CircleSquareHideAndSeek:
    """Wraps a ``VectorAPEnv`` whose env is an ``ImageClassificationEnv``
    over a single-object CircleSquare bank (possibly under ``Sparsify``)."""

    venv: VectorAPEnv
    mask_prediction: bool = False

    @property
    def num_envs(self) -> int:
        return self.venv.num_envs

    @property
    def env(self):
        return self.venv.env

    @property
    def autoreset(self):
        """Delegated, so ``with_autoreset`` recurses into ``venv``."""
        return self.venv.autoreset

    def inner_action_space(self, params):
        return self.venv.env.inner_action_space(params)

    def prediction_space(self, params):
        return TupleSpace(()) if self.mask_prediction else self.venv.env.prediction_space(params)

    def prediction_target_space(self, params):
        if self.mask_prediction:
            return TupleSpace(())
        return self.venv.env.prediction_target_space(params)

    def loss_fn(self, params):
        return ZeroLossFn() if self.mask_prediction else self.venv.env.loss_fn(params)

    # ------------------------------------------------------------------------
    def _object_pos_norm_and_sign(self, params, indices: torch.Tensor):
        h, w, _ = params.dataset.image_shape
        indices = indices.to(torch.int64)
        label = indices % 2
        rem = indices // 2
        lim = sensor_pos_lim_pixels((h, w), params.sensor_size, params.sensor_scale)
        # x / lim - 1 per axis, each scale a float32 constant passed to the
        # FMA by value: no host copy, so a CUDA graph can capture the step.
        pos_norm = torch.stack([
            fma(p, float(np.float32(1.0) / axis_lim), -1.0)
            for p, axis_lim in (((rem % w).to(torch.float32), lim[0]),
                                ((rem // w).to(torch.float32), lim[1]))
        ], dim=-1)
        sign = (label * 2 - 1).to(torch.float32)
        return pos_norm, sign

    def _augment(self, params, obs, reward, info):
        pos_norm, sign = self._object_pos_norm_and_sign(params, info["index"])
        additional = sign * norm2(obs["glimpse_pos"] - pos_norm)
        base = info["base_reward"] + additional
        if self.mask_prediction:
            new_reward = base
            t = info["prediction"]["target"]
            empty = {**t, "target": ()} if isinstance(t, dict) else ()
            prediction_info = {**info["prediction"], "target": empty}
        else:
            new_reward = reward + additional
            prediction_info = info["prediction"]
        return new_reward, {**info, "base_reward": base, "prediction": prediction_info}

    # ------------------------------------------------------------------------
    def reset(self, params, generator: torch.Generator | None = None, draws=None):
        obs, state, info = self.venv.reset(params, generator, draws=draws)
        if self.mask_prediction:
            info = {**info, "prediction": {**info.get("prediction", {}), "target": ()}}
        return obs, state, info

    def _inner_action(self, full_action: dict[str, Any], params):
        if not self.mask_prediction:
            return full_action
        k = self.venv.env.prediction_space(params).shape[-1]
        act = full_action["action"]
        return {"action": act,
                "prediction": torch.zeros((self.num_envs, k), dtype=torch.float32,
                                          device=act.device)}

    def step(self, state: VectorState, full_action: dict[str, Any], params,
             generator: torch.Generator | None = None, reset_draws=None, step_draws=None):
        obs, state2, reward, term, trunc, info = self.venv.step(
            state, self._inner_action(full_action, params), params, generator,
            reset_draws=reset_draws, step_draws=step_draws)
        reward, info = self._augment(params, obs, reward, info)
        return obs, state2, reward, term, trunc, info

    def boundary_reset_step(self, state: VectorState, full_action: dict[str, Any], params,
                            generator: torch.Generator | None = None, reset_draws=None,
                            step_draws=None):
        """The LOCKSTEP boundary step, with ``step``'s augmentation (the
        term of the new episode's object and glimpse position)."""
        obs, state2, reward, term, trunc, info = self.venv.boundary_reset_step(
            state, self._inner_action(full_action, params), params, generator,
            reset_draws=reset_draws, step_draws=step_draws)
        reward, info = self._augment(params, obs, reward, info)
        return obs, state2, reward, term, trunc, info
