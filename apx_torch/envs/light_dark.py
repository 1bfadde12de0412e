"""LightDark: noisy-observation position regression, batched over envs
(counterpart of apx.envs.light_dark).

Same semantics as apx's env: brightness(p) = h^2 / (|p - light|^2 + h^2)
with light (0, -0.7) and h = 0.2; the observation is the position plus
Gaussian noise of std (1 - brightness) * 0.3, clipped to [-2, 2]; base
reward 1 - 1e-3 |a|^2; the action is normalised into the unit ball and
scaled by 0.15; the episode terminates when a coordinate reaches |p| >= 1
(after the move, before the clip); the prediction target is the position
before the move.

It is the port's first env whose step draws random numbers: the reset
draws ``{"pos", "noise"}`` and every step ``{"noise"}``. The noise draws
are samples of N(0, 1/2), not N(0, 1): apx's ``jax.random.normal`` is
``sqrt(2) * erfinv(u)``, and XLA folds that sqrt(2) into obs_std's
constant, so the jitted reference computes ``fma(erfinv(u), (1 - b) *
f32(sqrt(2) * 0.3), pos)``. The port draws erfinv(u)'s law and rounds the
same way, so injected ``erfinv(u)`` draws give apx's observations bitwise.

apx's ``reset_prefers_merge`` has no counterpart: the port always runs the
masked merge, which apx pins bitwise to its ``lax.cond``.

On CUDA tensors the step and the reset's observation are kernel L, one
launch each (``ops.light_dark_cuda``), which raises on operands it cannot
take; on the CPU they are the plain forms, ``step_plain`` and
``noisy_position``, which L equals bitwise.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..core.env import APEnv, APStepResult, _need
from ..core.losses import LossFn
from ..core.numerics import fma, sum_squares
from ..core.spaces import Box, DictSpace, Space
from ..ops import light_dark_cuda
from ..ops.geometry import normalize_into_unit_ball
from .common import make_regression_loss_and_target_space

__all__ = ["LightDarkEnv", "LightDarkParams", "LightDarkState", "base_reward", "brightness",
           "moved_position", "noisy_position", "observe", "obs_std", "step_plain"]


@dataclasses.dataclass(frozen=True)
class LightDarkParams:
    light_pos: tuple[float, float] = (0.0, -0.7)
    light_height: float = 0.2
    move_scale: float = 0.15
    noise_scale: float = 0.3
    device: torch.device = torch.device("cuda")

    def __post_init__(self):
        object.__setattr__(self, "device", torch.device(self.device))

    @functools.cached_property
    def light(self) -> torch.Tensor:
        """(2,) f32 light position on the device (made once, outside any
        captured graph)."""
        return torch.tensor(self.light_pos, dtype=torch.float32, device=self.device)

    @property
    def light_height_sq(self) -> float:
        """f32(light_height^2), the h^2 of the brightness."""
        return float(np.float32(self.light_height ** 2))

    @property
    def folded_noise_scale(self) -> float:
        """f32(f32(sqrt 2) * noise_scale): the constant XLA folds from the
        normal's sqrt(2) and the noise scale (module docstring)."""
        return float(np.float32(np.sqrt(2)) * np.float32(self.noise_scale))


@dataclasses.dataclass
class LightDarkState:
    pos: torch.Tensor  # (N, 2) f32


def brightness(pos: torch.Tensor, params: LightDarkParams, fused: bool = True) -> torch.Tensor:
    """h^2 / (|pos - light|^2 + h^2) over the last axis, rounded as the
    jitted reference rounds it: the sum of squares contracted, then a true
    division. ``fused=False`` rounds each square, as apx's unjitted call
    does (its renderer's brightness field)."""
    h2 = params.light_height_sq
    d = pos - params.light
    dist_sq = (sum_squares(d) if fused else (d * d).sum(dim=-1)) + h2
    return torch.full_like(dist_sq, h2) / dist_sq


def obs_std(pos: torch.Tensor, params: LightDarkParams, fused: bool = True) -> torch.Tensor:
    """(1 - brightness) * noise_scale: the std of standard-normal noise."""
    return (1.0 - brightness(pos, params, fused)) * params.noise_scale


def noisy_position(pos, noise, scale: float, params: LightDarkParams) -> torch.Tensor:
    """clip(pos + noise * (1 - brightness) * scale, -2, 2), the add
    contracted into an FMA as in the jitted reference. ``scale`` is the
    noise scale for standard-normal noise and ``folded_noise_scale`` for
    the env's N(0, 1/2) draws. The plain form of L's reset (``observe``)."""
    std = (1.0 - brightness(pos, params)) * scale
    return fma(noise, std[:, None], pos).clamp(-2.0, 2.0)


def observe(pos, noise, scale: float, params: LightDarkParams) -> torch.Tensor:
    """``noisy_position``: one launch of L's reset on CUDA tensors, else
    the plain form."""
    if pos.device.type == "cuda":
        return light_dark_cuda.reset(pos.contiguous(), noise.contiguous(), params.light_pos,
                                     params.light_height_sq, scale)
    return noisy_position(pos, noise, scale, params)


def base_reward(action: torch.Tensor) -> torch.Tensor:
    """1 - 1e-3 |a|^2 as ``fma(-1e-3, sum_squares(a), 1)``."""
    return fma(-1e-3, sum_squares(action), 1.0)


def moved_position(pos, action, params: LightDarkParams) -> torch.Tensor:
    """pos + normalize_into_unit_ball(a) * move_scale, the add contracted."""
    move = normalize_into_unit_ball(action)
    return fma(move, params.move_scale, pos)


def step_plain(pos, action, noise, params: LightDarkParams) -> tuple[torch.Tensor, ...]:
    """(position, observation, base reward, terminated, truncated) of a
    step from ``pos``: the move, termination when a coordinate reaches
    |p| >= 1 (before the clip), the clip to [-1, 1], the noisy observation
    of the clipped position, the base reward. The plain form of L's step."""
    moved = moved_position(pos, action, params)
    terminated = (moved.abs() >= 1.0).any(dim=-1)
    moved = moved.clamp(-1.0, 1.0)
    return (moved, noisy_position(moved, noise, params.folded_noise_scale, params),
            base_reward(action), terminated, torch.zeros_like(terminated))


class LightDarkEnv(APEnv[LightDarkParams, LightDarkState]):
    def __init__(self, device="cuda"):
        self._device = device

    def default_params(self, **overrides) -> LightDarkParams:
        return LightDarkParams(**{"device": self._device, **overrides})

    # ---- spaces / loss ------------------------------------------------------
    def observation_space(self, params) -> Space:
        return DictSpace({"noisy_position": Box(low=-2.0, high=2.0, shape=(2,))})

    def inner_action_space(self, params) -> Space:
        return Box(low=-1.0, high=1.0, shape=(2,))

    def prediction_space(self, params) -> Space:
        return Box(low=-1.0, high=1.0, shape=(2,))

    def prediction_target_space(self, params) -> Space:
        return make_regression_loss_and_target_space(2, -1.0, 1.0)[1]

    def loss_fn(self, params) -> LossFn:
        # The jitted reference rounds this env's squares unfused (MSELossFn).
        return make_regression_loss_and_target_space(2, -1.0, 1.0, fused_sum=False)[0]

    # ---- dynamics -----------------------------------------------------------
    @staticmethod
    def _noise(num_envs, params, generator) -> torch.Tensor:
        """(N, 2) samples of N(0, 1/2) (module docstring)."""
        z = torch.randn((num_envs, 2), generator=_need(generator), device=params.device)
        return z * math.sqrt(0.5)

    def draw_reset(self, num_envs, params, generator) -> dict[str, torch.Tensor]:
        """pos ~ U[-1, 1)^2, then the observation noise."""
        pos = torch.rand((num_envs, 2), generator=_need(generator), device=params.device)
        return {"pos": pos * 2.0 - 1.0, "noise": self._noise(num_envs, params, generator)}

    def draw_step(self, num_envs, params, generator) -> dict[str, torch.Tensor]:
        return {"noise": self._noise(num_envs, params, generator)}

    def reset_from_draws(self, draws, params):
        pos = torch.as_tensor(draws["pos"], device=params.device).to(torch.float32)
        noise = torch.as_tensor(draws["noise"], device=params.device).to(torch.float32)
        obs = {"noisy_position": observe(pos, noise, params.folded_noise_scale, params)}
        return obs, LightDarkState(pos=pos), {}

    def step_env(self, state, action, prediction, params, draws=None) -> APStepResult:
        noise = draws["noise"]
        if state.pos.device.type == "cuda":
            out = light_dark_cuda.step(
                state.pos.contiguous(), action.contiguous(), noise.contiguous(),
                params.light_pos, params.light_height_sq, params.move_scale,
                params.folded_noise_scale)
        else:
            out = step_plain(state.pos, action, noise, params)
        pos, obs, reward, terminated, truncated = out
        return APStepResult(
            obs={"noisy_position": obs},
            state=LightDarkState(pos=pos),
            base_reward=reward,
            terminated=terminated,
            truncated=truncated,
            info={},
            prediction_target=state.pos,
        )

    def prediction_target_on_reset(self, old_state, new_state, params):
        return old_state.pos
