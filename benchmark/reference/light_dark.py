"""Plain reference of LightDark-v0's vector env under NEXT_STEP autoreset:
ap_gym's LightDark env (``ap_gym/envs/light_dark.py:14-247``, registered
as ``TimeLimit(LightDarkEnv(), 50, issue_termination=True)`` at
``ap_gym/envs/registration.py:640-647``), its normalized MSE loss on the
position and its reward, written from the env's semantics in plain
PyTorch.

It imports nothing of the port or of the JAX package. Every floating
quantity is computed in ``dtype``: float64 for the reference, a lower
precision for the control (``benchmark/control.py``). The draws are the
benchmark's inputs; the state is a dict of tensors

    pos (N, 2), t (N,) int64, prev_done (N,) bool

and the observation {noisy_position (N, 2), time_step (N,)}.

Semantics kept from ap_gym:

* the brightness at p is ``h^2 / (|p - light|^2 + h^2)``, with the light
  at (0, -0.7) and h = 0.2;
* the observation is the position plus Gaussian noise of std
  ``(1 - brightness) * 0.3``, clipped to [-2, 2];
* the reset draws the position uniform in [-1, 1)^2 and observes it;
* the step's base reward is ``1 - 1e-3 |a|^2`` of the raw action (the
  code's 1.0, where ap_gym's docstring says 0.1); the action is moved into
  the unit ball (divided by |a| where |a| > 1) and the position moves by
  0.15 times it; the episode terminates when a coordinate of the moved
  position reaches |p| >= 1, and the position is then clipped to [-1, 1];
  the new position is observed;
* the prediction target is the position before the move, the loss the
  normalized MSE ``3 mean((p - target)^2)`` (target std 2 / sqrt(12) on
  each axis) and the reward ``base - loss``;
* the time limit counts the steps of the episode, terminates on the 50th,
  and the observation carries ``time_step = 2 t / 50 - 1`` (-1 at the
  reset);
* NEXT_STEP autoreset: on the step after a done the env is reset from the
  reset draws instead of stepped, with reward 0, no done and t = 0.

Departures from ap_gym, each a reading of its randomness and not of its
mathematics:

* the draws are injected, not taken from numpy's generator: the position
  as a uniform sample in [-1, 1)^2 and each observation noise as a sample
  ``n`` of N(0, 1/2), scaled by ``sqrt(2) * 0.3 * (1 - brightness)`` (the
  same law as ap_gym's standard normal times the std; it is how the port
  reads its draws, and the configuration lists it under ``assumed``);
* the vector env steps every env and keeps the reset where the env was
  done, as apx's vector env does; ap_gym's vector wrapper resets the done
  envs on the next step, which gives the same outputs.
"""

from __future__ import annotations

import math

import torch

__all__ = ["LIGHT_POS", "LIGHT_HEIGHT", "NOISE_SCALE", "MOVE_SCALE", "OBS_CLIP", "TIME_LIMIT",
           "brightness", "observe", "time_step", "reset", "step", "vector_step"]

LIGHT_POS = (0.0, -0.7)
LIGHT_HEIGHT = 0.2
NOISE_SCALE = 0.3
MOVE_SCALE = 0.15
OBS_CLIP = 2.0
TIME_LIMIT = 50


def brightness(pos: torch.Tensor) -> torch.Tensor:
    """(N,) ``h^2 / (|pos - light|^2 + h^2)`` in the dtype of ``pos``."""
    light = torch.tensor(LIGHT_POS, dtype=pos.dtype, device=pos.device)
    h2 = LIGHT_HEIGHT * LIGHT_HEIGHT
    d = pos - light
    return h2 / ((d * d).sum(-1) + h2)


def observe(pos: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The noisy position of ``pos`` (N, 2) from the N(0, 1/2) draws
    ``noise`` (N, 2), in the dtype of ``pos``."""
    std = (1.0 - brightness(pos)) * NOISE_SCALE
    n = noise.to(pos.dtype) * math.sqrt(2.0)
    return (pos + n * std[:, None]).clamp(-OBS_CLIP, OBS_CLIP)


def time_step(t: torch.Tensor, dtype) -> torch.Tensor:
    """The time observation ``2 t / 50 - 1`` of the step counts ``t``."""
    return 2.0 * t.to(dtype) / TIME_LIMIT - 1.0


def reset(pos: torch.Tensor, noise: torch.Tensor, dtype) -> tuple[dict, dict]:
    """(obs, state) of envs reset to ``pos`` (N, 2) observed with ``noise``."""
    pos = pos.to(dtype)
    n = pos.shape[0]
    t = torch.zeros(n, dtype=torch.int64, device=pos.device)
    obs = {"noisy_position": observe(pos, noise), "time_step": time_step(t, dtype)}
    state = {"pos": pos, "t": t,
             "prev_done": torch.zeros(n, dtype=torch.bool, device=pos.device)}
    return obs, state


def step(pos: torch.Tensor, action: torch.Tensor, noise: torch.Tensor):
    """One step of the env (no time limit, no autoreset) from ``pos``:
    (noisy position, new position, base reward, terminated, target)."""
    a = action.to(pos.dtype)
    sq = (a * a).sum(-1)
    base_reward = 1.0 - 1e-3 * sq
    mag = torch.sqrt(sq)[:, None]
    unit = torch.where(mag > 1.0, a / torch.where(mag == 0.0, 1.0, mag), a)
    moved = pos + unit * MOVE_SCALE
    terminated = (moved.abs() >= 1.0).any(-1)
    new = moved.clamp(-1.0, 1.0)
    return observe(new, noise), new, base_reward, terminated, pos


def vector_step(state: dict, action: torch.Tensor, prediction: torch.Tensor,
                step_noise: torch.Tensor, reset_pos: torch.Tensor, reset_noise: torch.Tensor):
    """One NEXT_STEP vector step of ``TimeLimit(env, 50,
    issue_termination=True)``: the envs done at the previous step are reset
    from (reset_pos, reset_noise) instead of stepped. Returns (obs, state,
    reward, terminated, truncated)."""
    pos, dt = state["pos"], state["pos"].dtype
    mask = state["prev_done"]
    noisy, new_pos, base, terminated, target = step(pos, action, step_noise)
    t1 = state["t"] + 1
    terminated = terminated | (t1 >= TIME_LIMIT)
    r_obs, r_state = reset(reset_pos, reset_noise, dt)
    m2 = mask[:, None]
    new_pos = torch.where(m2, r_state["pos"], new_pos)
    noisy = torch.where(m2, r_obs["noisy_position"], noisy)
    t = torch.where(mask, torch.zeros_like(t1), t1)
    terminated = terminated & ~mask
    truncated = torch.zeros_like(terminated)
    diff = prediction.to(dt) - target
    loss = 3.0 * (diff * diff).mean(-1)
    reward = torch.where(mask, torch.zeros_like(loss), base - loss)
    obs = {"noisy_position": noisy, "time_step": time_step(t, dt)}
    new = {"pos": new_pos, "t": t, "prev_done": terminated | truncated}
    return obs, new, reward, terminated, truncated
