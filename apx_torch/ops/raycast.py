"""Batched segment raycasting against unit-cell occupancy grids: the plain
PyTorch forms (counterpart of apx.ops.raycast).

A wall cell (row y, col x) spans [x, x+1] x [y, y+1]. For each env n and
segment r the slab test against every cell gives the nearest hit
parameter; the result is ``max(t_hit * |d| - eps, 0)`` on a hit and
``|d|`` on a miss. ``geos_typing=True`` adds the reference's GEOS
result-typing of zero-width corner grazes (see apx.ops.raycast's module
docstring for the cases); it matters for scans cast from exact cell
centres, i.e. at reset.

These forms are what the CUDA kernels in ``apx_torch/csrc/raycast_slab.cu``
are held to bitwise, and what runs when the tensors lie on the CPU
(``apx_torch.ops.raycast_cuda`` dispatches). They round exactly as apx's
jitted casts do: the pulled-back hit distance is ``fma(t_hit, |d|, -eps)``
and, by default, ``|d| = sqrt(fma(dy, dy, dx*dx))`` (see ``core.numerics``;
a caller whose reference site rounds |d| otherwise passes ``seg``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.numerics import fma, sqrt

__all__ = ["lidar_directions", "lidar_directions_np", "pad_occupancy", "raycast_grid",
           "seg_length"]

EPS = 1e-3
_INF = float("inf")


def lidar_directions_np(beam_count: int) -> np.ndarray:
    """(B, 2) f32 unit beam directions at angles linspace(-pi, pi, B,
    endpoint=False)."""
    ang = np.linspace(-np.pi, np.pi, beam_count, dtype=np.float32, endpoint=False)
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1)


def lidar_directions(beam_count: int, device="cpu") -> torch.Tensor:
    return torch.from_numpy(lidar_directions_np(beam_count)).to(device)


def seg_length(d: torch.Tensor) -> torch.Tensor:
    """|d| over the last axis (size 2), rounded as ``jnp.linalg.norm``."""
    dx, dy = d[..., 0], d[..., 1]
    return sqrt(fma(dy, dy, dx * dx))


def pad_occupancy(occ: torch.Tensor, pad: int) -> torch.Tensor:
    """(N, H, W) bool -> (N, H + 2 pad, W + 2 pad), padded with non-wall
    cells on both axes so windows cut around any in-map position stay in
    range."""
    n, h, w = occ.shape
    out = torch.zeros((n, h + 2 * pad, w + 2 * pad), dtype=torch.bool, device=occ.device)
    out[:, pad:pad + h, pad:pad + w] = occ
    return out


def _slab_axis(o, d, lo, hi):
    """Per-axis slab entry/exit parameters; handles d == 0 exactly.
    o, d: (N, R, 1); lo, hi: (K,) cell bounds -> near, far (N, R, K)."""
    zero = d == 0.0
    inv = torch.where(zero, _INF, torch.reciprocal(torch.where(zero, 1.0, d)))
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    near = torch.minimum(t1, t2)
    far = torch.maximum(t1, t2)
    inside = (lo <= o) & (o <= hi)
    near = torch.where(zero, torch.where(inside, -_INF, _INF), near)
    far = torch.where(zero, torch.where(inside, _INF, -_INF), far)
    return near, far


def raycast_grid(
    occ: torch.Tensor,
    origin: torch.Tensor,
    targets: torch.Tensor,
    seg: torch.Tensor | None = None,
    eps: float = EPS,
    geos_typing: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cast segments origin[n] -> targets[n, r] against the walls of occ[n].

    Args:
      occ: (N, H, W) bool occupancy, True = wall.
      origin: (N, 2) f32 (x, y).
      targets: (N, R, 2) f32.
      seg: (N, R) f32 segment lengths; default ``seg_length(targets - origin)``.
    Returns:
      distances (N, R) f32 and hit parameters (N, R) f32 (+inf on a miss).
    """
    n, h, w = occ.shape
    occb = occ.to(torch.bool)
    dev = occ.device
    o = origin.to(torch.float32)[:, None, :]  # (N, 1, 2)
    d = targets.to(torch.float32) - o  # (N, R, 2)
    if seg is None:
        seg = seg_length(d)  # (N, R)

    col = torch.arange(w, dtype=torch.float32, device=dev)
    row = torch.arange(h, dtype=torch.float32, device=dev)
    nx1, fx1 = _slab_axis(o[..., 0:1], d[..., 0:1], col, col + 1.0)  # (N, R, W)
    ny1, fy1 = _slab_axis(o[..., 1:2], d[..., 1:2], row, row + 1.0)  # (N, R, H)
    occ_r = occb[:, None]  # (N, 1, H, W)

    if not geos_typing:
        # The [0, 1] clips distribute over the per-cell max/min exactly, so
        # they are applied once per column and per row.
        nx0 = nx1.clamp_min(0.0)[:, :, None, :]
        fxc = fx1.clamp_max(1.0)[:, :, None, :]
        ny0 = ny1.clamp_min(0.0)[:, :, :, None]
        fyc = fy1.clamp_max(1.0)[:, :, :, None]
        a = torch.maximum(nx0, ny0)  # (N, R, H, W)
        b = torch.minimum(fxc, fyc)
        valid = occ_r & (a <= b)
        t_hit = torch.where(valid, a, _INF).amin(dim=(-2, -1))  # (N, R)
        dist = torch.where(
            torch.isfinite(t_hit), fma(t_hit, seg, -eps).clamp_min(0.0), seg
        )
        return dist, t_hit

    # 4-neighbour occupancy (False outside the grid) for the isolated-graze
    # test.
    pad = torch.zeros((n, h + 2, w + 2), dtype=torch.bool, device=dev)
    pad[:, 1:-1, 1:-1] = occb
    occ_xm = pad[:, None, 1:-1, :-2]  # cell (x-1, y)
    occ_xp = pad[:, None, 1:-1, 2:]   # cell (x+1, y)
    occ_ym = pad[:, None, :-2, 1:-1]  # cell (x, y-1)
    occ_yp = pad[:, None, 2:, 1:-1]   # cell (x, y+1)
    sx_pos = (d[..., 0] >= 0.0)[:, :, None, None]  # (N, R, 1, 1)
    sy_pos = (d[..., 1] >= 0.0)[:, :, None, None]

    nx = nx1[:, :, None, :]
    fx = fx1[:, :, None, :]
    ny = ny1[:, :, :, None]
    fy = fy1[:, :, :, None]
    a = torch.maximum(nx, ny).clamp_min(0.0)  # clipped entry (N, R, H, W)
    b = torch.minimum(fx, fy).clamp_max(1.0)  # clipped exit
    valid = occ_r & (a <= b)
    nd = valid & (a < b)  # real crossing interval
    dg = valid & (a == b)  # zero-width graze

    # Flanking cells of a grazed corner: case A (entry from x == exit from
    # y) passes from cell (cx - sx, cy) into (cx, cy + sy); case B mirrors
    # it. An occupied flank merges the graze into an adjacent crossing.
    case_a = nx >= ny
    flank_a = torch.where(sy_pos, occ_yp, occ_ym) | torch.where(sx_pos, occ_xm, occ_xp)
    flank_b = torch.where(sx_pos, occ_xp, occ_xm) | torch.where(sy_pos, occ_ym, occ_yp)
    iso = dg & ~torch.where(case_a, flank_a, flank_b)

    cells = (-2, -1)
    any_nd = nd.any(dim=-1).any(dim=-1)
    t_nd = torch.where(nd, a, _INF).amin(dim=cells)
    any_iso = iso.any(dim=-1).any(dim=-1)
    t_iso_min = torch.where(iso, a, _INF).amin(dim=cells)
    t_iso_max = torch.where(iso, a, -_INF).amax(dim=cells)

    # GEOS result typing: line-only -> nearest entry; points-only -> Point
    # (dist 0) or MultiPoint (nearest graze); mixed -> GeometryCollection,
    # which the reference treats as a miss.
    hit_line = any_nd & ~any_iso
    multi_pt = ~any_nd & any_iso & (t_iso_min < t_iso_max)
    single_pt = ~any_nd & any_iso & (t_iso_min == t_iso_max)
    t_hit = torch.where(
        hit_line, t_nd, torch.where(multi_pt | single_pt, t_iso_min, _INF)
    )
    dist = torch.where(
        single_pt,
        0.0,
        torch.where(torch.isfinite(t_hit), fma(t_hit, seg, -eps).clamp_min(0.0), seg),
    )
    return dist, t_hit
