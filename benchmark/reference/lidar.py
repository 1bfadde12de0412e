"""Plain reference of LIDARLocRooms-v0's vector env under NEXT_STEP
autoreset: ap_gym's LIDAR localization env (8 beams of range 5 over a
32x32 occupancy map, a move that stops 1e-3 before the first wall and
slides along it, termination on leaving the map, a 100-step time limit that
terminates), its MSE loss on the position and its reward, written from the
env's semantics in plain PyTorch.

It imports nothing of the port or of the JAX package. Every floating
quantity is computed in ``dtype``: float64 for the reference, a lower
precision for the control (``benchmark/control.py``). The map, the bank's
dataset indices and the draws are the benchmark's inputs; the state is a
dict of tensors:

    occ (N, H, W) bool, bank_pos (N,) int64, map_idx (N,) int64,
    pos (N, 2), initial_pos (N, 2), odo_pending (N,) bool,
    t (N,) int64, prev_done (N,) bool

and the observation {lidar (N, B), odometry (N, 2), map (N, H, W, 1),
time_step (N,)}.

Semantics kept from ap_gym (and apx's port of it):

* the cast from o to o + d (segment length |d|) hits the first occupied
  cell whose slab interval [max(near_x, near_y, 0), min(far_x, far_y, 1)]
  is not empty; the distance is ``max(t |d| - 1e-3, 0)``, or |d| on a miss;
* the reset's scan types the hits as shapely does: crossings only give the
  nearest entry; isolated corner grazes only give the nearest graze (0 if
  they all coincide); both together are a miss;
* the move: the base reward ``0.1 - 1e-3 |a|^2`` of the raw action; the
  action moved into the unit ball; the move to 1e-3 before the wall; the
  wall slide's candidates keep only remaining components above 1e-5, and a
  single survivor v is tried on both axes as (v, 0) and (0, v); the first
  candidate with a positive free distance slides;
* the odometry origin is the position after the first step's move (before
  the clip), the position is clipped to [0, size], the prediction target is
  the pre-step position scaled to [-1, 1];
* the loss is the normalized MSE ``3 mean((p - target)^2)`` and the reward
  ``base - loss``; on the step after a done the env is reset from the draws
  (the k-th free cell's centre of map ``bank_pos``), with reward 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Bank", "beam_offsets", "cast", "reset", "step", "vector_step", "EPS", "SLIDE_EPS",
           "TIME_LIMIT"]

EPS = 1e-3
SLIDE_EPS = 1e-5
TIME_LIMIT = 100
LIDAR_RANGE = 5.0
BEAMS = 8


def beam_offsets(beams: int = BEAMS, lidar_range: float = LIDAR_RANGE) -> torch.Tensor:
    """(B, 2) beam offsets at angles linspace(-pi, pi, B, endpoint=False),
    times the range, as the env states them in float32."""
    ang = np.linspace(-np.pi, np.pi, beams, dtype=np.float32, endpoint=False)
    d = np.stack([np.cos(ang), np.sin(ang)], axis=-1) * np.float32(lidar_range)
    return torch.from_numpy(d.astype(np.float32))


class Bank:
    """The maps (M, H, W) bool and their dataset indices (M,), with each
    map's free cells in row-major order (the spawn's k-th free cell)."""

    def __init__(self, maps: torch.Tensor, indices: torch.Tensor):
        self.maps = maps.to(torch.bool)
        self.indices = indices.to(torch.int64)
        m, h, w = self.maps.shape
        free = ~self.maps.reshape(m, h * w)
        self.free_counts = free.sum(-1)
        order = torch.argsort((~free).to(torch.int8), dim=-1, stable=True)
        self.free_cells = order  # the first free_counts[m] entries are the free cells


def _slab(o: torch.Tensor, d: torch.Tensor, size: int):
    """near, far (N, R, size) of the segments o + t d along one axis (o, d
    (N, R, 1)) against the unit slabs [k, k + 1]."""
    lo = torch.arange(size, dtype=o.dtype, device=o.device)
    hi = lo + 1.0
    zero = d == 0.0
    safe = torch.where(zero, torch.ones_like(d), d)
    t1, t2 = (lo - o) / safe, (hi - o) / safe
    near, far = torch.minimum(t1, t2), torch.maximum(t1, t2)
    inside = (lo <= o) & (o <= hi)
    near = torch.where(zero, torch.where(inside, -math.inf, math.inf), near)
    far = torch.where(zero, torch.where(inside, math.inf, -math.inf), far)
    return near, far


def cast(occ: torch.Tensor, origin: torch.Tensor, targets: torch.Tensor,
         typed: bool = False) -> torch.Tensor:
    """(N, R) distances of the casts origin (N, 2) -> targets (N, R, 2) on
    maps occ (N, H, W) bool, in the dtype of ``origin``."""
    n, h, w = occ.shape
    o = origin[:, None, :]
    d = targets - o
    seg = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    nx, fx = _slab(o[..., 0:1], d[..., 0:1], w)
    ny, fy = _slab(o[..., 1:2], d[..., 1:2], h)
    nx, fx = nx[:, :, None, :], fx[:, :, None, :]
    ny, fy = ny[:, :, :, None], fy[:, :, :, None]
    a = torch.maximum(nx, ny).clamp_min(0.0)
    b = torch.minimum(fx, fy).clamp_max(1.0)
    wall = occ[:, None]
    valid = wall & (a <= b)
    inf = torch.full((), math.inf, dtype=a.dtype, device=a.device)
    if not typed:
        t_hit = torch.where(valid, a, inf).amin(dim=(-2, -1))
        return torch.where(torch.isfinite(t_hit), (t_hit * seg - EPS).clamp_min(0.0), seg)
    pad = torch.zeros((n, h + 2, w + 2), dtype=torch.bool, device=occ.device)
    pad[:, 1:-1, 1:-1] = occ
    xm, xp = pad[:, None, 1:-1, :-2], pad[:, None, 1:-1, 2:]
    ym, yp = pad[:, None, :-2, 1:-1], pad[:, None, 2:, 1:-1]
    sx = (d[..., 0] >= 0.0)[:, :, None, None]
    sy = (d[..., 1] >= 0.0)[:, :, None, None]
    crossing = valid & (a < b)
    graze = valid & (a == b)
    # A corner graze whose flanking cell is a wall joins the adjacent
    # crossing: entering from x as y is left passes from (x - sx, y) into
    # (x, y + sy); the other case mirrors it.
    flank_a = torch.where(sy, yp, ym) | torch.where(sx, xm, xp)
    flank_b = torch.where(sx, xp, xm) | torch.where(sy, ym, yp)
    iso = graze & ~torch.where(nx >= ny, flank_a, flank_b)
    any_cross = crossing.any(-1).any(-1)
    any_iso = iso.any(-1).any(-1)
    t_cross = torch.where(crossing, a, inf).amin(dim=(-2, -1))
    t_iso_min = torch.where(iso, a, inf).amin(dim=(-2, -1))
    t_iso_max = torch.where(iso, a, -inf).amax(dim=(-2, -1))
    line = any_cross & ~any_iso
    points = ~any_cross & any_iso
    single = points & (t_iso_min == t_iso_max)
    t_hit = torch.where(line, t_cross, torch.where(points, t_iso_min, inf))
    dist = torch.where(torch.isfinite(t_hit), (t_hit * seg - EPS).clamp_min(0.0), seg)
    return torch.where(single, torch.zeros_like(dist), dist)


def reset(bank: Bank, bank_pos: torch.Tensor, k: torch.Tensor, dtype, offsets: torch.Tensor):
    """(obs, state) of envs reset to the k-th free cell's centre of map
    ``bank_pos``: the typed scan from there, the odometry origin pending."""
    m, h, w = bank.maps.shape
    bank_pos = bank_pos.to(torch.int64)
    occ = bank.maps[bank_pos]
    flat = bank.free_cells[bank_pos, k.to(torch.int64)]
    pos = torch.stack([flat % w, flat // w], dim=-1).to(dtype) + 0.5
    dist = cast(occ, pos, pos[:, None, :] + offsets.to(dtype), typed=True)
    n = pos.shape[0]
    obs = {"lidar": (dist / LIDAR_RANGE).clamp(-1.0, 1.0), "odometry": torch.zeros_like(pos)}
    state = {"occ": occ, "bank_pos": bank_pos, "map_idx": bank.indices[bank_pos], "pos": pos,
             "initial_pos": pos.clone(),
             "odo_pending": torch.ones(n, dtype=torch.bool, device=pos.device)}
    return obs, state


def step(state: dict, action: torch.Tensor, offsets: torch.Tensor, casts: list | None = None):
    """One step of the env (no time limit, no autoreset): returns (obs,
    state, base_reward, terminated, target). ``casts``, when given,
    collects each cast's (origin, targets)."""
    occ, pos, dt = state["occ"], state["pos"], state["pos"].dtype
    n, h, w = occ.shape
    size = torch.tensor([w, h], dtype=dt, device=pos.device)
    action = action.to(dt)

    def run_cast(origin, targets):
        if casts is not None:
            casts.append((origin, targets))
        return cast(occ, origin, targets)

    base_reward = 0.1 - 1e-3 * (action * action).sum(-1)
    mag = torch.sqrt((action * action).sum(-1, keepdim=True))
    a = torch.where(mag > 1.0, action / torch.where(mag == 0.0, 1.0, mag), action)
    total = torch.sqrt((a * a).sum(-1))
    direction = a / torch.where(total == 0.0, 1.0, total)[:, None]
    d2w = run_cast(pos, (pos + a)[:, None, :])[:, 0]
    pos1 = pos + direction * d2w[:, None]
    rem = total - d2w
    rem_vec = direction * rem[:, None]
    keep = rem_vec > SLIDE_EPS
    n_keep = keep.sum(-1)
    single = torch.where(keep, rem_vec, torch.zeros_like(rem_vec)).amax(-1)
    diag = torch.where((n_keep == 2)[:, None], rem_vec, single[:, None].expand(-1, 2))
    zero = torch.zeros_like(diag[:, 0])
    cand = torch.stack([torch.stack([diag[:, 0], zero], -1),
                        torch.stack([zero, diag[:, 1]], -1)], 1)  # (N, 2, 2)
    cand_dist = run_cast(pos1, pos1[:, None, :] + cand)
    use0 = cand_dist[:, 0] > 0.0
    sel = torch.where(use0[:, None], cand[:, 0], cand[:, 1])
    sel_diag = torch.where(use0, diag[:, 0], diag[:, 1])
    sel_dist = torch.where(use0, cand_dist[:, 0], cand_dist[:, 1])
    unit = sel / torch.where(sel_diag == 0.0, 1.0, sel_diag)[:, None]
    slide = (total > 0.0) & (rem > SLIDE_EPS) & (n_keep > 0)
    pos2 = torch.where(slide[:, None], pos1 + unit * sel_dist[:, None], pos1)
    pos2 = torch.where((total > 0.0)[:, None], pos2, pos)
    terminated = (pos2 < 0.0).any(-1) | (pos2 >= size).any(-1)
    initial = torch.where(state["odo_pending"][:, None], pos2, state["initial_pos"])
    pos2 = torch.minimum(pos2.clamp_min(0.0), size)
    target = pos / size * 2.0 - 1.0
    dist = run_cast(pos2, pos2[:, None, :] + offsets.to(dt))
    obs = {"lidar": (dist / LIDAR_RANGE).clamp(-1.0, 1.0), "odometry": (pos2 - initial) / size}
    new = {**state, "pos": pos2, "initial_pos": initial,
           "odo_pending": torch.zeros_like(state["odo_pending"])}
    return obs, new, base_reward, terminated, target


def _select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)


def vector_step(state: dict, action: torch.Tensor, prediction: torch.Tensor, bank: Bank,
                reset_bank_pos: torch.Tensor, reset_k: torch.Tensor, offsets: torch.Tensor,
                casts: list | None = None):
    """One NEXT_STEP vector step of ``TimeLimit(env, 100,
    issue_termination=True)``: the envs done at the previous step are
    reset from (reset_bank_pos, reset_k) instead of stepped. Returns (obs,
    state, reward, terminated, truncated)."""
    dt = state["pos"].dtype
    mask = state["prev_done"]
    s_obs, s_state, base, terminated, target = step(state, action, offsets, casts)
    t1 = state["t"] + 1
    terminated = terminated | (t1 >= TIME_LIMIT)
    obs, new = dict(s_obs), {k: v for k, v in s_state.items() if k not in ("t", "prev_done")}
    idx = torch.nonzero(mask).flatten()
    if idx.numel():
        r_obs, r_state = reset(bank, reset_bank_pos[idx], reset_k[idx], dt, offsets)
        for key in obs:
            obs[key] = obs[key].clone()
            obs[key][idx] = r_obs[key]
        for key in new:
            new[key] = new[key].clone()
            new[key][idx] = r_state[key]
    t = torch.where(mask, torch.zeros_like(t1), t1)
    terminated = terminated & ~mask
    truncated = torch.zeros_like(terminated)
    pred = prediction.to(dt)
    loss = 3.0 * ((pred - target) ** 2).mean(-1)
    reward = torch.where(mask, torch.zeros_like(loss), base - loss)
    obs["map"] = new["occ"][..., None].to(dt) / 255.0
    obs["time_step"] = 2.0 * t.to(dt) / TIME_LIMIT - 1.0
    new.update(t=t, prev_done=terminated | truncated)
    return obs, new, reward, terminated, truncated
