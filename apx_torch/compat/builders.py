"""Batched resets and steps from host-drawn randomness (counterpart of
apx.compat.builders).

``reset_from_draws(env, draws, params)`` turns host draws into a batched
(obs, state, info) shaped like the env's own reset and lifts it through
the wrapper stack with ``wrap_reset``. ``apply_step_draws`` overwrites the
stochastic part of a raw batched step result with host draws (LightDark's
observation noise, the only env step that draws); ``unwrap_state`` digs to
the base env's state.
"""

from __future__ import annotations

from typing import Any

import torch

from ..envs.image_classification import ImageClassificationEnv
from ..envs.image_localization import ImageLocalizationEnv
from ..envs.image_perception import ImagePerceptionEngine
from ..envs.lidar_localization import (LIDARBitslabState, LIDARLocalizationEnv,
                                       LIDARLocalizationState)
from ..ops.raycast import pack_row_halves
from ..envs.light_dark import LightDarkEnv, LightDarkState, observe
from ..wrappers.base import APWrapper

__all__ = ["reset_from_draws", "apply_step_draws", "unwrap_state"]


def _wrapper_stack(env) -> list[APWrapper]:
    stack = []
    while isinstance(env, APWrapper):
        stack.append(env)
        env = env.env
    return stack  # outermost first


def unwrap_state(state):
    """Dig to the base env's state through wrapper states (``inner``)."""
    while hasattr(state, "inner"):
        state = state.inner
    return state


def _base_reset_from_draws(base, draws: dict[str, Any], params):
    if isinstance(base, ImageClassificationEnv):
        # draws {"index", "inverted", "pos"}: the env's own reset_from_draws.
        return base.reset_from_draws(draws, params)
    if isinstance(base, ImageLocalizationEnv):
        # draws {"index", "inverted", "pos", "target"}: the target is
        # resolved on the host, for the sampler's reset and the uniform
        # autoreset alike.
        perception = ImagePerceptionEngine.reset_from_draws(draws, params)
        target = torch.as_tensor(draws["target"], dtype=torch.float32, device=params.device)
        state = base.make_state(perception, target, params)
        return base.observe(state, params), state, ImagePerceptionEngine.info(perception)
    if isinstance(base, LIDARLocalizationEnv):
        dev = params.device
        occ = torch.as_tensor(draws["occ"], dtype=torch.bool, device=dev)
        pos = torch.as_tensor(draws["pos"], dtype=torch.float32, device=dev)
        n = occ.shape[0]
        leaves = dict(
            occ=occ,
            bank_pos=torch.zeros(n, dtype=torch.int64, device=dev),
            map_idx=torch.as_tensor(draws["map_idx"], dtype=torch.int64, device=dev),
            pos=pos,
            initial_pos=pos,
            odo_pending=torch.ones(n, dtype=torch.bool, device=dev),
        )
        if params.needs_row_halves:  # the bit windows' rows, packed from the host map
            state = LIDARBitslabState(**leaves, row_halves=pack_row_halves(occ))
        else:
            state = LIDARLocalizationState(**leaves)
        obs = {
            **base._observe(state, params),
            **base.obs_derived_from_state(state, params),
        }
        return obs, state, base._info(state)
    if isinstance(base, LightDarkEnv):
        # Host draws are standard-normal noise, scaled by obs_std itself.
        dev = params.device
        pos = torch.as_tensor(draws["pos"], dtype=torch.float32, device=dev)
        noise = torch.as_tensor(draws["noise"], dtype=torch.float32, device=dev)
        obs = {"noisy_position": observe(pos, noise, params.noise_scale, params)}
        return obs, LightDarkState(pos=pos), {}
    raise TypeError(f"No reset builder for {type(base).__name__}")


def reset_from_draws(env, draws: dict[str, Any], params):
    """Batched (obs, state, info) from host draws, wrapper stack applied:
    ``{"occ", "pos", "map_idx"}`` for LIDAR envs, ``{"index", "inverted",
    "pos"}`` for image classification envs, the same and ``"target"`` for
    image localization envs, ``{"pos", "noise"}`` (noise standard normal)
    for LightDark."""
    stack = _wrapper_stack(env)
    base = stack[-1].env if stack else env
    obs, state, info = _base_reset_from_draws(base, draws, params)
    for w in reversed(stack):  # innermost wrapper first
        obs, state, info = w.wrap_reset(obs, state, info, params)
    return obs, state, info


def apply_step_draws(env, result, draws: dict[str, Any] | None, params):
    """Overwrite the stochastic parts of a raw batched step result with
    host draws: LightDark's observation from standard-normal ``noise``
    (N, 2) at the moved position, ``clip(fma(noise, obs_std(pos), pos), -2,
    2)``, the rounding of apx's jitted adapter step. Other envs' steps draw
    nothing and pass through."""
    if draws is None:
        return result
    base = env
    while isinstance(base, APWrapper):
        base = base.env
    if isinstance(base, LightDarkEnv) and "noise" in draws:
        pos = unwrap_state(result.state).pos
        noise = torch.as_tensor(draws["noise"], dtype=torch.float32, device=pos.device)
        noisy = observe(pos, noise, params.noise_scale, params)
        return result.replace(obs={**result.obs, "noisy_position": noisy})
    return result
