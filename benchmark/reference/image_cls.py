"""Plain reference of TinyImageNet-v0's vector env stepped in episodic
cycles (LOCKSTEP autoreset with the boundary hoisted out: one all-env reset
step, then 16 steps without autoreset): ap_gym's image classification env
(a 10x10 glimpse sensor over 64x64x3 uint8 images, moves of at most 0.2 per
axis, 16 steps an episode), its normalized cross-entropy loss on the
image's label over the 200 logits of the prediction, and its reward,
written from the env's semantics in plain PyTorch.

It imports nothing of the port or of the JAX package; the glimpse is the
localization reference's (``reference/image_loc.py``, plain PyTorch too).
Every floating quantity is computed in ``dtype`` (float64 for the
reference, a lower precision for the control). The image bank, its labels
and the draws are the benchmark's inputs. The state is a dict of tensors:

    data_index (N,) int64, pos (N, 2), time (N,) int64, prev_done (N,) bool

and the observation {glimpse (N, s0, s1, C), glimpse_pos (N, 2),
time_step (N,)}. The label is the bank's label of ``data_index``.

Semantics kept from ap_gym (and apx's port of it):

* the glimpse, the move (``pos + 0.2 * a'``, a' the action projected into
  the unit disc, clipped to [-1, 1]), the base reward ``-1e-3 |a|``, the
  termination when the time reaches 16 and the time observation
  ``2 t / 16 - 1`` are the localization env's (``reference/image_loc.py``);
* the loss is the cross-entropy normalized by its blind guess,
  ``(logsumexp(p) - p[label]) / log(200)``, computed in ``dtype`` from the
  float32 logits; the reward is ``base - loss``;
* the boundary step resets every env from the draws (image ``index``,
  position ``pos``), with base reward 0, no done, and the loss taken
  against the new image's label.

Departures from ap_gym, each the port's as well:

* the episodes run under the vector env's LOCKSTEP autoreset, where
  ap_gym's vector env resets each env on the step after its own end. Every
  episode lasts exactly 16 steps, so both reset every env on the same step;
  LOCKSTEP's reset step reports the new episode's first observation with
  base reward 0 and no done, as the boundary step here does;
* no label is ever inverted (``randomly_invert_labels`` is False for the
  id), so the observation has no ``inverted_label``.
"""

from __future__ import annotations

import math

import torch

from .image_loc import MAX_STEP, SENSOR, STEP_LIMIT, glimpse

__all__ = ["cross_entropy", "reset", "step", "boundary_step", "MAX_STEP", "STEP_LIMIT",
           "SENSOR", "CLASSES"]

CLASSES = 200


def cross_entropy(prediction: torch.Tensor, label: torch.Tensor, dtype) -> torch.Tensor:
    """(N,) normalized cross-entropy of the logits ``prediction`` (N, C)
    against ``label`` (N,), in ``dtype``."""
    p = prediction.to(dtype)
    picked = p.gather(-1, label.to(torch.int64)[:, None])[:, 0]
    return (torch.logsumexp(p, dim=-1) - picked) / math.log(p.shape[-1])


def reset(bank: torch.Tensor, index: torch.Tensor, pos: torch.Tensor,
          dtype) -> tuple[dict, dict]:
    """(obs, state) of envs reset to image ``index`` at ``pos``."""
    index = index.to(torch.int64)
    pos = pos.to(dtype)
    n = index.shape[0]
    state = {"data_index": index, "pos": pos,
             "time": torch.zeros(n, dtype=torch.int64, device=index.device),
             "prev_done": torch.zeros(n, dtype=torch.bool, device=index.device)}
    obs = {"glimpse": glimpse(bank[index], pos), "glimpse_pos": pos,
           "time_step": torch.full((n,), -1.0, dtype=dtype, device=index.device)}
    return obs, state


def step(bank: torch.Tensor, labels: torch.Tensor, state: dict, action: torch.Tensor,
         prediction: torch.Tensor, positions: list | None = None):
    """One step without autoreset: returns (obs, state, reward, terminated,
    truncated). ``positions``, when given, collects the glimpse's
    positions."""
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
           "time_step": 2.0 * time.to(dt) / STEP_LIMIT - 1.0}
    new = {**state, "pos": pos, "time": time, "prev_done": terminated | truncated}
    reward = base - cross_entropy(prediction, labels[state["data_index"]], dt)
    return obs, new, reward, terminated, truncated


def boundary_step(bank: torch.Tensor, labels: torch.Tensor, prediction: torch.Tensor, index,
                  pos, dtype, positions: list | None = None):
    """The all-env reset step: every env reset from the draws, reward
    ``-loss`` against the new image's label, no done."""
    obs, new = reset(bank, index, pos, dtype)
    if positions is not None:
        positions.append(new["pos"])
    reward = -cross_entropy(prediction, labels[new["data_index"]], dtype)
    done = torch.zeros_like(new["prev_done"])
    return obs, new, reward, done, done
