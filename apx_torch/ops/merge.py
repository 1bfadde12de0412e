"""The NEXT_STEP merge with the loss and reward, in plain PyTorch: the
plain form of F2 (``apx_torch.ops.merge_cuda``), and the merge of every
loss F2 does not compute.

A NEXT_STEP vector step runs the step and the reset for all N envs and
keeps, env by env, the reset's result where the env was done at the
previous step (``mask``); the reset's other envs are never read (LIDAR's
reset leaves them unwritten). ``next_step`` is that merge as
``VectorAPEnv.step`` composes it:

* every leaf of the step's and the reset's (obs, state, info) selected by
  ``mask`` (``tree_select``);
* the step counter of a ``TimeLimit`` (its ``Counter``), kept here
  instead of in the wrapper: ``Counter.tick``, then 0 where reset; the
  time observation of the merged count;
* the base reward 0 and the dones False where reset;
* the loss and reward (``core.losses.masked_loss_and_reward``), 0 where
  reset;
* the observation entries derived from the merged state
  (``derived``: a bool state leaf divided by a constant, LIDAR's map).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.env import tree_select
from ..core.losses import LossFn, masked_loss_and_reward
from ..core.numerics import div

__all__ = ["Merged", "next_step"]


@dataclasses.dataclass
class Merged:
    """The merged step: ``obs``, ``state``, ``info`` in the reset trees'
    structure; ``derived`` the derived obs entries (None when no spec was
    given); ``t`` and ``time_obs`` the counter's (None without one)."""

    obs: Any
    state: Any
    info: Any
    derived: dict[str, torch.Tensor] | None
    base_reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    done: torch.Tensor
    loss: torch.Tensor
    reward: torch.Tensor
    t: torch.Tensor | None
    time_obs: torch.Tensor | None


def next_step(mask: torch.Tensor, step: tuple, reset: tuple, base_reward: torch.Tensor,
              terminated: torch.Tensor, truncated: torch.Tensor, prediction: torch.Tensor,
              target: torch.Tensor, loss_fn: LossFn,
              derived: dict[str, tuple[str, float]] | None = None,
              counter=None) -> Merged:
    """The merge of ``step`` and ``reset``, each (obs, state, info), under
    ``mask`` (N,) bool; ``terminated``, ``truncated`` and ``base_reward``
    are the step's, ``target`` its prediction target; ``derived`` maps an
    obs key to (state field, divisor): ``state.<field>[..., None]`` as
    float32 divided by the divisor; ``counter`` a ``TimeLimit``'s
    ``Counter`` (``wrappers.time_limit``) or None."""
    (s_obs, s_state, s_info), (r_obs, r_state, r_info) = step, reset
    obs = tree_select(mask, r_obs, s_obs)
    state = tree_select(mask, r_state, s_state)
    info = tree_select(mask, r_info, s_info)
    t = tobs = None
    if counter is not None:
        t1, terminated, truncated = counter.tick(terminated, truncated)
        t = torch.where(mask, 0, t1)
        tobs = counter.time_obs(t) if counter.observe else None
    base = torch.where(mask, 0.0, base_reward)
    terminated = mask.logical_not() & terminated
    truncated = mask.logical_not() & truncated
    derived_obs = None if derived is None else {
        key: div(getattr(state, leaf)[..., None].to(torch.float32), divisor)
        for key, (leaf, divisor) in derived.items()}
    loss, reward = masked_loss_and_reward(loss_fn, mask, base, prediction, target)
    return Merged(obs, state, info, derived_obs, base, terminated, truncated,
                  terminated | truncated, loss, reward, t, tobs)
