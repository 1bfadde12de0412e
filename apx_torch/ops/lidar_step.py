"""The LIDAR step's arithmetic around its three casts, as four plain stages
(the plain form of F1, ``apx_torch.ops.lidar_step_cuda``).

The LIDAR step is K1's three casts with these stages between them
(``staged_step``):

* ``stage_a`` (before the move cast): the base reward, the action moved
  into the unit ball, its length and direction, the move's target and,
  where the reference rounds it unfused, the move cast's |d| in the cast's
  frame;
* ``stage_b`` (after the move cast's distance to the wall): the position
  at the wall and the reference's wall-slide candidates, with their
  targets;
* ``stage_c`` (after the candidates' distances): the slide, the
  out-of-map termination, the odometry origin, the clip, the prediction
  target and the beam targets;
* ``stage_d`` (after the beam scan): the lidar and odometry observations.

Each keeps the operators and rounding sites of the monolithic step it was
cut from (``core.numerics``' FMA, sum-of-squares and root sites; true
divisions; the float32 reciprocals of the map size and range), so the
staged step equals apx's jitted step bitwise. On the card these are the
yardstick F1's kernels are held to; N1-N3 compute their ``fma``,
``sum_squares`` and ``sqrt`` there.
"""

from __future__ import annotations

import torch

from ..core.numerics import fma, sqrt, sum_squares
from .geometry import normalize_into_unit_ball
from .raycast import seg_length

__all__ = ["stage_a", "stage_b", "stage_c", "stage_d", "staged_step", "unfused_length",
           "SLIDE_EPS", "STEP_LEAVES"]

SLIDE_EPS = 1e-5  # the reference's wall-slide threshold, compared in float32


def unfused_length(origin: torch.Tensor, targets: torch.Tensor,
                   base: torch.Tensor | None = None) -> torch.Tensor:
    """(N, R) |targets - origin| with the square rounded unfused,
    ``sqrt(dx*dx + dy*dy)``; in the window frame of ``base`` (N, 2) when
    given (``origin - base``, ``targets - base``), as the cast sees them."""
    if base is not None:
        origin, targets = origin - base, targets - base[:, None, :]
    d = targets - origin[:, None, :]
    return sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def stage_a(action: torch.Tensor, pos: torch.Tensor, unfused_len: bool,
            base: torch.Tensor | None = None) -> dict[str, torch.Tensor | None]:
    """Before the move cast. action, pos (N, 2) f32; ``unfused_len``: the
    move cast's |d| rounded unfused (``params.move_len_contracted`` false),
    in the frame of ``base`` when the cast runs on a window. Returns
    base_reward (N,), total (N,), direction (N, 2), move_to (N, 1, 2) and
    seg (N, 1), or None where K1 computes the contracted length itself."""
    base_reward = fma(-1e-3, sum_squares(action), 0.1)
    a = normalize_into_unit_ball(action)
    total = seg_length(a)
    direction = a / torch.where(total == 0.0, 1.0, total)[:, None]
    move_to = (pos + a)[:, None, :]
    seg = unfused_length(pos, move_to, base) if unfused_len else None
    return {"base_reward": base_reward, "total": total, "direction": direction,
            "move_to": move_to, "seg": seg}


def stage_b(pos: torch.Tensor, direction: torch.Tensor, total: torch.Tensor,
            d2w: torch.Tensor) -> dict[str, torch.Tensor]:
    """After the move cast, whose distance to the wall is d2w (N,). The
    wall slide keeps the reference's quirks: only components > 1e-5
    (positive!) survive, and a single survivor v becomes diag([v, v]),
    candidates on BOTH axes. Returns pos1 (N, 2), rem (N,), n_keep (N,)
    int64, cand_diag (N, 2), cand (N, 2, 2) and cand_targets (N, 2, 2)."""
    pos1 = fma(direction, d2w[:, None], pos)
    rem = total - d2w
    rem_vec = direction * rem[:, None]
    keep = rem_vec > SLIDE_EPS
    n_keep = keep.sum(dim=-1)
    v_single = torch.where(keep, rem_vec, 0.0).amax(dim=-1)
    cand_diag = torch.where((n_keep == 2)[:, None], rem_vec, v_single[:, None].expand(-1, 2))
    eye = torch.eye(2, dtype=torch.float32, device=pos.device)
    cand = eye * cand_diag[:, None, :]  # (N, 2, 2) candidate moves
    return {"pos1": pos1, "rem": rem, "n_keep": n_keep, "cand_diag": cand_diag, "cand": cand,
            "cand_targets": pos1[:, None, :] + cand}


def stage_c(pos: torch.Tensor, pos1: torch.Tensor, total: torch.Tensor, rem: torch.Tensor,
            n_keep: torch.Tensor, cand: torch.Tensor, cand_diag: torch.Tensor,
            cand_dist: torch.Tensor, odo_pending: torch.Tensor, initial_pos: torch.Tensor,
            map_size: torch.Tensor, inv_map_size: torch.Tensor,
            beam_offsets: torch.Tensor) -> dict[str, torch.Tensor]:
    """After the candidates' casts (cand_dist (N, 2)): the surviving
    candidate as a binary select (apx's form), the slide, termination on
    leaving [0, size), the odometry origin (locked to the pre-clip moved
    position on the first step after a reset), the clip, the prediction
    target ``fma(pos, 2 / size, -1)`` of the pre-step position and the
    beam targets of the new one. Returns pos (N, 2), initial_pos (N, 2),
    odo_pending (N,) (all False), terminated (N,), truncated (N,) (all
    False), target (N, 2) and beam_targets (N, B, 2)."""
    use0 = cand_dist[:, 0] > 0.0
    sel_cand = torch.where(use0[:, None], cand[:, 0], cand[:, 1])
    sel_diag = torch.where(use0, cand_diag[:, 0], cand_diag[:, 1])
    sel_dist = torch.where(use0, cand_dist[:, 0], cand_dist[:, 1])
    unit = sel_cand / torch.where(sel_diag == 0.0, 1.0, sel_diag)[:, None]
    do_slide = (total > 0.0) & (rem > SLIDE_EPS) & (n_keep > 0)
    pos2 = torch.where(do_slide[:, None], fma(unit, sel_dist[:, None], pos1), pos1)
    pos2 = torch.where((total > 0.0)[:, None], pos2, pos)
    terminated = (pos2 < 0.0).any(dim=-1) | (pos2 >= map_size).any(dim=-1)
    new_initial = torch.where(odo_pending[:, None], pos2, initial_pos)
    pos2 = torch.minimum(pos2.clamp_min(0.0), map_size)
    return {"pos": pos2, "initial_pos": new_initial, "odo_pending": torch.zeros_like(odo_pending),
            "terminated": terminated, "truncated": torch.zeros_like(terminated),
            "target": fma(pos, 2.0 * inv_map_size, -1.0),
            "beam_targets": pos2[:, None, :] + beam_offsets}


def stage_d(dist: torch.Tensor, pos: torch.Tensor, initial_pos: torch.Tensor, inv_range: float,
            inv_map_size: torch.Tensor) -> dict[str, torch.Tensor]:
    """After the beam scan (dist (N, B)): ``lidar = clamp(dist * inv_range,
    -1, 1)`` (XLA's multiply by the float32 reciprocal of the range) and
    ``odometry = (pos - initial_pos) * inv_map_size``."""
    return {"lidar": (dist * inv_range).clamp(-1.0, 1.0),
            "odometry": (pos - initial_pos) * inv_map_size}


# What a step returns (``staged_step``, and kernel S's outputs).
STEP_LEAVES = ("pos", "initial_pos", "odo_pending", "base_reward", "terminated", "truncated",
               "target", "lidar", "odometry")


def staged_step(stages, action: torch.Tensor, pos: torch.Tensor, odo_pending: torch.Tensor,
                initial_pos: torch.Tensor, map_size: torch.Tensor, inv_map_size: torch.Tensor,
                beam_offsets: torch.Tensor, inv_range: float, cast_move, cast_candidates, scan,
                unfused_len: bool = True,
                base: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """The step as stage A, the move cast, stage B, the candidates' cast,
    stage C, the beam scan and stage D. ``stages`` holds ``stage_a`` ..
    ``stage_d`` (this module's plain stages, or F1's kernels,
    ``lidar_step_cuda``); ``cast_move(origin, targets, seg)``,
    ``cast_candidates(origin, targets)`` and ``scan(pos, targets)`` give
    the (N, R) distances; ``unfused_len`` and ``base`` are stage A's.
    Returns the ``STEP_LEAVES``: the new pos, initial_pos and odo_pending,
    base_reward, terminated, truncated, the prediction target, lidar and
    odometry."""
    a = stages.stage_a(action, pos, unfused_len, base)
    d2w = cast_move(pos, a["move_to"], a["seg"])
    b = stages.stage_b(pos, a["direction"], a["total"], d2w[:, 0].contiguous())
    cand_dist = cast_candidates(b["pos1"], b["cand_targets"])
    c = stages.stage_c(pos, b["pos1"], a["total"], b["rem"], b["n_keep"], b["cand"],
                       b["cand_diag"], cand_dist.contiguous(), odo_pending, initial_pos,
                       map_size, inv_map_size, beam_offsets)
    dist = scan(c["pos"], c["beam_targets"])
    d = stages.stage_d(dist.contiguous(), c["pos"], c["initial_pos"], inv_range, inv_map_size)
    return {**{k: c[k] for k in ("pos", "initial_pos", "odo_pending")},
            "base_reward": a["base_reward"],
            **{k: c[k] for k in ("terminated", "truncated", "target")}, **d}
