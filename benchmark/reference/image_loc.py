"""Plain reference of TinyImageNetLoc-v0's vector env stepped in episodic
cycles (LOCKSTEP autoreset with the boundary hoisted out: 16 steps without
autoreset, then one all-env reset step): ap_gym's image localization env
(a 10x10 glimpse sensor over 64x64x3 uint8 images, moves of at most 0.2
per axis, 16 steps an episode), its normalized MSE loss on the target
position and its reward, written from the env's semantics in plain
PyTorch.

It imports nothing of the port or of the JAX package. Every floating
quantity is computed in ``dtype`` (float64 for the reference, a lower
precision for the control). The image bank and the draws are the
benchmark's inputs. The state is a dict of tensors:

    data_index (N,) int64, pos (N, 2), time (N,) int64, target (N, 2),
    target_glimpse (N, s0, s1, C), prev_done (N,) bool

and the observation {glimpse (N, s0, s1, C), glimpse_pos (N, 2),
time_step (N,), target_glimpse (N, s0, s1, C)}.

Semantics kept from ap_gym (and apx's port of it):

* a glimpse samples an (s0, s1) grid, 1 pixel apart, centred at pixel
  ``pos * lim + (size - 1) / 2`` with ``lim = (size - 1) / 2 - (s - 1) / 2``
  (x pairs the width with s0), by bilinear interpolation of the image / 255
  with coordinates clipped to the image, and clips the result to [0, 1];
* a step moves ``pos + 0.2 * a'`` (a' the action projected into the unit
  disc), clipped to [-1, 1]; the base reward is ``-1e-3 |a|``; the episode
  terminates when its time reaches 16; the time observation is
  ``2 t / 16 - 1``;
* the loss is ``3 mean((p - target)^2)``, the reward ``base - loss``;
* the boundary step resets every env from the draws (image ``index``,
  position ``pos``, target ``target``), with base reward 0, the loss taken
  against the previous episode's target, and no done.
"""

from __future__ import annotations

import torch

__all__ = ["glimpse", "reset", "step", "boundary_step", "MAX_STEP", "STEP_LIMIT", "SENSOR"]

MAX_STEP = 0.2
STEP_LIMIT = 16
SENSOR = (10, 10)


def _hats(coords: torch.Tensor, size: int) -> torch.Tensor:
    """(..., s, size) bilinear weights ``max(0, 1 - |c - k|)`` of the sample
    coordinates (..., s), clipped to [0, size - 1]."""
    c = coords.clamp(0.0, size - 1)
    grid = torch.arange(size, dtype=coords.dtype, device=coords.device)
    return (1.0 - (c[..., None] - grid).abs()).clamp_min(0.0)


def glimpse(images: torch.Tensor, pos: torch.Tensor, sensor=SENSOR) -> torch.Tensor:
    """(N, s0, s1, C) glimpses of uint8 images (N, H, W, C) at ``pos`` (N, 2)
    in the dtype of ``pos``."""
    n, h, w, c = images.shape
    dt = pos.dtype
    s0, s1 = sensor
    lim_x = (w - 1) / 2 - (s0 - 1) / 2
    lim_y = (h - 1) / 2 - (s1 - 1) / 2
    offs0 = torch.arange(s0, dtype=dt, device=pos.device) - (s0 - 1) / 2
    offs1 = torch.arange(s1, dtype=dt, device=pos.device) - (s1 - 1) / 2
    rows = (pos[:, 1] * lim_y + (h - 1) / 2)[:, None] + offs0
    cols = (pos[:, 0] * lim_x + (w - 1) / 2)[:, None] + offs1
    img = images.to(dt) / 255.0
    tmp = torch.einsum("nsh,nhwc->nswc", _hats(rows, h), img)
    return torch.einsum("nswc,ntw->nstc", tmp, _hats(cols, w)).clamp(0.0, 1.0)


def reset(bank: torch.Tensor, index: torch.Tensor, pos: torch.Tensor,
          target: torch.Tensor, dtype) -> tuple[dict, dict]:
    """(obs, state) of envs reset to image ``index`` at ``pos`` with the
    target ``target``."""
    index = index.to(torch.int64)
    images = bank[index]
    pos, target = pos.to(dtype), target.to(dtype)
    tg = glimpse(images, target)
    n = index.shape[0]
    state = {"data_index": index, "pos": pos,
             "time": torch.zeros(n, dtype=torch.int64, device=index.device),
             "target": target, "target_glimpse": tg,
             "prev_done": torch.zeros(n, dtype=torch.bool, device=index.device)}
    obs = {"glimpse": glimpse(images, pos), "glimpse_pos": pos,
           "time_step": torch.full((n,), -1.0, dtype=dtype, device=index.device),
           "target_glimpse": tg}
    return obs, state


def _loss(prediction: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return 3.0 * ((prediction.to(target.dtype) - target) ** 2).mean(-1)


def step(bank: torch.Tensor, state: dict, action: torch.Tensor, prediction: torch.Tensor,
         positions: list | None = None):
    """One step without autoreset: returns (obs, state, reward, terminated,
    truncated). ``positions``, when given, collects the glimpses' positions."""
    dt = state["pos"].dtype
    a = action.to(dt)
    mag = torch.sqrt((a * a).sum(-1, keepdim=True))
    proj = torch.where(mag > 1.0, a / mag.clamp_min(1.0), a)
    pos = (state["pos"] + MAX_STEP * proj).clamp(-1.0, 1.0)
    base = -1e-3 * mag[:, 0]
    time = state["time"] + 1
    terminated = time >= STEP_LIMIT
    truncated = torch.zeros_like(terminated)
    if positions is not None:
        positions.append(pos)
    obs = {"glimpse": glimpse(bank[state["data_index"]], pos), "glimpse_pos": pos,
           "time_step": 2.0 * time.to(dt) / STEP_LIMIT - 1.0,
           "target_glimpse": state["target_glimpse"]}
    new = {**state, "pos": pos, "time": time, "prev_done": terminated | truncated}
    reward = base - _loss(prediction, state["target"])
    return obs, new, reward, terminated, truncated


def boundary_step(bank: torch.Tensor, state: dict, prediction: torch.Tensor, index, pos, target,
                  positions: list | None = None):
    """The all-env reset step: every env reset from the draws, reward
    ``-loss`` against the previous target, no done."""
    obs, new = reset(bank, index, pos, target, state["pos"].dtype)
    if positions is not None:
        positions.extend([new["target"], new["pos"]])
    reward = -_loss(prediction, state["target"])
    done = torch.zeros_like(state["prev_done"])
    return obs, new, reward, done, done
