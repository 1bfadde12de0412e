"""The LIDAR env's step and reset on the whole map, as plain PyTorch: the
plain forms of kernels S and R (``apx_torch.ops.lidar_fused_cuda``).

* ``step_plain``: F1's four plain stages (``ops.lidar_step``) with the
  three plain casts between them (``ops.raycast.raycast_grid``): the move
  with stage A's unfused |d|, the two wall-slide candidates and the beams
  with the contracted |d| (``raycast.seg_length``), as apx's jitted step
  rounds them on the whole map;
* ``reset_plain``: the spawn's map and position from the bank's row words
  (``spawn_leaves``), the reset scan from the spawn cell's centre (typed,
  or untyped as apx's ``"pallas"`` backend scans) and the observation
  (``reset_observation``). Given a mask it writes ``RESET_POISON`` into
  the envs the mask leaves out, whose slots R leaves unwritten, so that a
  consumer reading one breaks the bitwise tests on the CPU.

They run on the CPU, and on the card they are what S and R are held to
(their ``fma`` / ``sum_squares`` / ``sqrt`` then launch N1-N3).
"""

from __future__ import annotations

import torch

from ..core.numerics import div
from ..data.floor_map import unpack_words
from . import lidar_step
from .raycast import EPS, raycast_grid, seg_length

__all__ = ["step_plain", "reset_plain", "spawn_leaves", "reset_observation", "whole_map_cast",
           "RESET_LEAVES", "RESET_POISON"]

# What a reset returns (``reset_plain``, and kernel R's outputs), then
# ``map_idx`` where the reset read the bank itself.
RESET_LEAVES = ("occ", "pos", "odo_pending", "lidar", "odometry")
# What ``reset_plain`` writes into the envs a mask leaves out, by leaf:
# none of it is a value a reset can give.
RESET_POISON = {"occ": True, "pos": float("nan"), "odo_pending": False, "lidar": float("nan"),
                "odometry": float("nan"), "map_idx": -1}


def whole_map_cast(occ: torch.Tensor, typed: bool):
    """``cast(origin, targets, seg=None)``: the plain cast on the whole map
    ``occ`` (typed or not), with the contracted |d| where no ``seg`` is
    given (as K1 computes it)."""

    def cast(origin, targets, seg=None):
        if seg is None:
            seg = seg_length(targets - origin[:, None, :])
        return raycast_grid(occ, origin, targets, seg, eps=EPS, geos_typing=typed)[0]

    return cast


def step_plain(occ: torch.Tensor, action: torch.Tensor, pos: torch.Tensor,
               odo_pending: torch.Tensor, initial_pos: torch.Tensor, map_size: torch.Tensor,
               inv_map_size: torch.Tensor, beam_offsets: torch.Tensor,
               inv_range: float) -> dict[str, torch.Tensor]:
    """One LIDAR step with every cast on the whole map ``occ`` (N, H, W)
    bool: action, pos, initial_pos (N, 2) f32, odo_pending (N,) bool,
    map_size and inv_map_size (2,) f32, beam_offsets (B, 2) f32,
    ``inv_range`` the float32 1 / range. Returns ``lidar_step.STEP_LEAVES``."""
    cast = whole_map_cast(occ, typed=False)
    return lidar_step.staged_step(lidar_step, action, pos, odo_pending, initial_pos, map_size,
                                  inv_map_size, beam_offsets, inv_range, cast, cast, cast)


def spawn_leaves(words: torch.Tensor, flat: torch.Tensor,
                 w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The spawned map (N, H, W) bool from row words (N, H) and the
    position (N, 2) f32, the centre of row-major cell ``flat`` (N,)."""
    pos = torch.stack([flat % w, flat // w], dim=-1).to(torch.float32) + 0.5
    return unpack_words(words, w), pos


def reset_observation(dist: torch.Tensor, pos: torch.Tensor, initial_pos: torch.Tensor,
                      lidar_range: float, inv_map_size: torch.Tensor) -> dict[str, torch.Tensor]:
    """The reset's observation: the scan's distances divided by the range
    (a true division; the step multiplies by the reciprocal,
    ``lidar_step.stage_d``) and clamped, and the odometry."""
    return {"lidar": div(dist, lidar_range).clamp(-1.0, 1.0),
            "odometry": (pos - initial_pos) * inv_map_size}


def reset_plain(words: torch.Tensor, flat: torch.Tensor, w: int, beam_offsets: torch.Tensor,
                lidar_range: float, inv_map_size: torch.Tensor, typed: bool = True,
                only: torch.Tensor | None = None,
                fetch: tuple | None = None) -> dict[str, torch.Tensor]:
    """The reset from ``MapBank.spawn``'s row words (N, H) int64 and
    spawn cells ``flat`` (N,) int64, on maps W cells wide: the scan from
    the spawn position to ``pos + beam_offsets`` on the whole map (typed,
    or untyped) and its observation. Returns ``RESET_LEAVES``; the odometry
    origin is the position itself. With ``fetch`` = (bank_pos, k, indices)
    (N,), (N,), (M,) int64, ``words`` and ``flat`` are the bank's (M, H)
    row words and (M, max_free) free cells, read as ``MapBank.spawn`` reads
    them, and ``map_idx`` = indices[bank_pos] follows. ``only`` (N,) bool:
    the envs left out get ``RESET_POISON``."""
    map_idx = None
    if fetch is not None:
        bank_pos, k, indices = fetch
        words, flat, map_idx = words[bank_pos], flat[bank_pos, k], indices[bank_pos]
    occ, pos = spawn_leaves(words, flat, w)
    dist = whole_map_cast(occ, typed)(pos, pos[:, None, :] + beam_offsets)
    out = {"occ": occ, "pos": pos,
           "odo_pending": torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device),
           **reset_observation(dist, pos, pos, lidar_range, inv_map_size)}
    if map_idx is not None:
        out["map_idx"] = map_idx
    if only is None:
        return out
    return {k: torch.where(only.reshape(-1, *[1] * (v.ndim - 1)), v,
                           torch.tensor(RESET_POISON[k], dtype=v.dtype, device=v.device))
            for k, v in out.items()}
