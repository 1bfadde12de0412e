"""Batched segment raycasting against unit-cell occupancy grids: the plain
PyTorch forms (counterpart of apx.ops.raycast).

A wall cell (row y, col x) spans [x, x+1] x [y, y+1]. For each env n and
segment r the slab test against every cell gives the nearest hit
parameter; the result is ``max(t_hit * |d| - eps, 0)`` on a hit and
``|d|`` on a miss. ``geos_typing=True`` adds the reference's GEOS
result-typing of zero-width corner grazes (see apx.ops.raycast's module
docstring for the cases); it matters for scans cast from exact cell
centres, i.e. at reset.

The dense forms are what the CUDA kernels in ``apx_torch/csrc/raycast_slab.cu``
are held to bitwise, and what runs when the tensors lie on the CPU
(``apx_torch.ops.raycast_cuda`` dispatches).

The other forms are apx's A/B raycast backends, which apx computes in
plain XLA outside any Pallas kernel; here they are plain PyTorch on every
device:

* the bit-packed windows (``pack_row_halves``, ``bitslab_window``,
  ``bitslab_window_2d``) and the casts on them (``raycast_grid_bitslab``,
  ``raycast_grid_bitslab2d``, ``raycast_grid_bitslab2d_per_ray`` with
  ``beam_cell_rects``), which keep the lattice in map coordinates
  (``base + iota``) and so equal the dense fast cast bitwise;
* ``windowed_window`` / ``raycast_grid_windowed`` (the window around each
  origin, cut by ``ops.window.cut_windows``, cast in the window frame) and
  ``extract_window_mxu`` (one-hot products);
* ``lidar_table_scan``, the 8-beam scan as one lookup per beam in the
  tables of ``data.floor_map.build_beam_tables``;
* ``contact_cells``, a render helper.

torch has no shifts on uint32, so the bit forms shift int32 and int64
words. They round exactly as apx's
jitted casts do: the pulled-back hit distance is ``fma(t_hit, |d|, -eps)``
and, by default, ``|d| = sqrt(fma(dy, dy, dx*dx))`` (see ``core.numerics``;
a caller whose reference site rounds |d| otherwise passes ``seg``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.numerics import fma, sqrt
from .window import cut_windows

__all__ = ["lidar_directions", "lidar_directions_np", "pad_occupancy", "raycast_grid",
           "seg_length", "pack_row_halves", "bitslab_window", "bitslab_window_2d",
           "raycast_grid_bitslab", "raycast_grid_bitslab2d", "beam_cell_rects",
           "raycast_grid_bitslab2d_per_ray", "windowed_window", "raycast_grid_windowed",
           "contact_cells", "extract_window_mxu", "lidar_table_scan"]

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


def _pull_back(t_hit: torch.Tensor, seg: torch.Tensor, eps: float) -> torch.Tensor:
    """Hit distance ``max(t_hit |d| - eps, 0)`` (contracted, as apx's jitted
    casts round it), or ``|d|`` on a miss."""
    return torch.where(torch.isfinite(t_hit), fma(t_hit, seg, -eps).clamp_min(0.0), seg)


def _fast_lattice(occ, o, d, seg, col, row, eps):
    """The untyped slab cast of segments (o, d) against the cells of
    ``occ`` (N, Hw, Ww) whose map columns and rows are ``col`` (N, Ww) and
    ``row`` (N, Hw): the dense fast path's per-cell expressions."""
    nx1, fx1 = _slab_axis(o[..., 0:1], d[..., 0:1], col[:, None, :], col[:, None, :] + 1.0)
    ny1, fy1 = _slab_axis(o[..., 1:2], d[..., 1:2], row[:, None, :], row[:, None, :] + 1.0)
    a = torch.maximum(nx1.clamp_min(0.0)[:, :, None, :], ny1.clamp_min(0.0)[:, :, :, None])
    b = torch.minimum(fx1.clamp_max(1.0)[:, :, None, :], fy1.clamp_max(1.0)[:, :, :, None])
    valid = occ[:, None] & (a <= b)
    t_hit = torch.where(valid, a, _INF).amin(dim=(-2, -1))
    return _pull_back(t_hit, seg, eps), t_hit


def _segments(origin, targets, seg):
    o = origin.to(torch.float32)[:, None, :]
    d = targets.to(torch.float32) - o
    return o, d, seg_length(d) if seg is None else seg


def pack_row_halves(occ: torch.Tensor) -> torch.Tensor:
    """(..., H, 2) int32: each row of the (..., H, W) bool maps packed
    little-endian into two 16-bit half-words (bit x of half x // 16 is cell
    (row, x)). W <= 32."""
    h, w = occ.shape[-2:]
    if w > 32:
        raise ValueError(f"pack_row_halves supports W <= 32, got {w}")
    bits = torch.nn.functional.pad(occ.to(torch.int32), (0, 32 - w))
    weights = torch.tensor([1 << i for i in range(16)], dtype=torch.int32, device=occ.device)
    return (bits.reshape(*occ.shape[:-2], h, 2, 16) * weights).sum(-1, dtype=torch.int32)


def bitslab_window(halves: torch.Tensor, base_x: torch.Tensor, w: int) -> torch.Tensor:
    """(N, H, 16) bool occupancy of map columns [base_x, base_x + 16) from
    row halves (N, H, 2) int32 and integer starts base_x (N,): a half-word
    select, a variable right shift and a mask. Columns outside [0, w) read
    as free."""
    x = base_x.to(torch.int32)[:, None] + torch.arange(16, dtype=torch.int32,
                                                        device=halves.device)  # (N, 16)
    valid = (x >= 0) & (x < w)
    xc = x.clamp(0, w - 1)[:, None, :]
    half = torch.where(xc < 16, halves[:, :, 0:1], halves[:, :, 1:2])  # (N, H, 16)
    bit = (half >> (xc & 15)) & 1
    return valid[:, None, :] & (bit == 1)


def bitslab_window_2d(halves: torch.Tensor, base_x: torch.Tensor, base_y: torch.Tensor,
                      w: int) -> torch.Tensor:
    """(N, 16, 16) bool occupancy of map rows [base_y, base_y + 16) x
    columns [base_x, base_x + 16): the columns of ``bitslab_window`` are
    packed into one word each (bit y = row y), and the row window is a
    second variable shift. Cells outside the map read as free. H <= 32."""
    h = halves.shape[1]
    if h > 32:
        raise ValueError(f"bitslab_window_2d supports H <= 32, got {h}")
    dev = halves.device
    bit = bitslab_window(halves, base_x, w).to(torch.int64)  # (N, H, 16)
    colw = (bit << torch.arange(h, dtype=torch.int64, device=dev)[:, None]).sum(1)  # (N, 16)
    y = base_y.to(torch.int64)[:, None] + torch.arange(16, dtype=torch.int64, device=dev)
    validy = (y >= 0) & (y < h)
    yc = y.clamp(0, h - 1)
    out = (colw[:, None, :] >> yc[:, :, None]) & 1  # (N, 16 rows, 16 cols)
    return (out == 1) & validy[:, :, None]


def _window_lattice(base: torch.Tensor, size: int) -> torch.Tensor:
    """(N, size) f32 map coordinates ``base + iota`` of a window's cells."""
    return base.to(torch.float32)[:, None] + torch.arange(size, dtype=torch.float32,
                                                          device=base.device)


def raycast_grid_bitslab(occ_win: torch.Tensor, base_x: torch.Tensor, origin: torch.Tensor,
                         targets: torch.Tensor, seg: torch.Tensor | None = None,
                         eps: float = EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """The untyped cast against the 16-column window ``occ_win`` (N, H, 16)
    of map columns [base_x, base_x + 16) (base_x (N,) f32, integer-valued).
    The lattice stays in map coordinates, so every per-cell value is the
    dense fast path's and, when every cell a cast can meet lies in the
    window, the result is bitwise ``raycast_grid(geos_typing=False)``'s."""
    o, d, seg = _segments(origin, targets, seg)
    h = occ_win.shape[1]
    row = torch.arange(h, dtype=torch.float32, device=occ_win.device).expand(
        occ_win.shape[0], h)
    return _fast_lattice(occ_win, o, d, seg, _window_lattice(base_x, 16), row, eps)


def raycast_grid_bitslab2d(occ_win: torch.Tensor, base_x: torch.Tensor, base_y: torch.Tensor,
                           origin: torch.Tensor, targets: torch.Tensor,
                           seg: torch.Tensor | None = None,
                           eps: float = EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """The untyped cast against the 2-D window ``occ_win`` (N, Hw, Ww) of map
    rows [base_y, base_y + Hw) x columns [base_x, base_x + Ww), in map
    coordinates as ``raycast_grid_bitslab``: bitwise the dense fast cast
    whenever the window holds every cell a cast can meet (a static sub-slice
    of ``bitslab_window_2d`` with its bases moved along)."""
    o, d, seg = _segments(origin, targets, seg)
    _, hw, ww = occ_win.shape
    return _fast_lattice(occ_win, o, d, seg, _window_lattice(base_x, ww),
                         _window_lattice(base_y, hw), eps)


def beam_cell_rects(offsets, win_size: int, o_lo: float,
                    o_hi: float) -> tuple[tuple[int, int, int, int], ...]:
    """Static per-ray window rectangles ((x0, x1, y0, y1), ...), in window
    indices [0, win_size), holding every cell a cast from any origin in
    window coordinates [o_lo, o_hi]^2 (closed) along the displacement
    ``offsets[r]`` can meet (apx's derivation: a cell outside its segment's
    closed extent fails a <= b exactly, so the reduce over the rectangle
    equals the whole window's)."""
    import math

    rects = []
    for rx, ry in np.asarray(offsets, dtype=np.float32):
        x0 = math.floor(o_lo + min(0.0, float(rx))) - 1
        x1 = math.floor(o_hi + max(0.0, float(rx))) + 1
        y0 = math.floor(o_lo + min(0.0, float(ry))) - 1
        y1 = math.floor(o_hi + max(0.0, float(ry))) + 1
        rects.append((max(x0, 0), min(x1, win_size), max(y0, 0), min(y1, win_size)))
    return tuple(rects)


def raycast_grid_bitslab2d_per_ray(occ_win: torch.Tensor, base_x: torch.Tensor,
                                   base_y: torch.Tensor, origin: torch.Tensor,
                                   targets: torch.Tensor,
                                   rects: tuple[tuple[int, int, int, int], ...],
                                   seg: torch.Tensor | None = None,
                                   eps: float = EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """``raycast_grid_bitslab2d`` with ray r reduced over its static
    rectangle ``rects[r]`` (``beam_cell_rects``) only. The slab values are
    sliced from the per-axis arrays of the whole window, so each kept cell's
    (a, b) is the shared form's and the result is bitwise equal; padded
    slots hold a = inf and never count."""
    o, d, seg = _segments(origin, targets, seg)
    _, hw, ww = occ_win.shape
    col, row = _window_lattice(base_x, ww), _window_lattice(base_y, hw)
    nx1, fx1 = _slab_axis(o[..., 0:1], d[..., 0:1], col[:, None, :], col[:, None, :] + 1.0)
    ny1, fy1 = _slab_axis(o[..., 1:2], d[..., 1:2], row[:, None, :], row[:, None, :] + 1.0)
    m = max((x1 - x0) * (y1 - y0) for x0, x1, y0, y1 in rects)
    t_rows = []
    for r, (x0, x1, y0, y1) in enumerate(rects):
        a = torch.maximum(nx1[:, r, None, x0:x1].clamp_min(0.0),
                          ny1[:, r, y0:y1, None].clamp_min(0.0)).flatten(1)
        b = torch.minimum(fx1[:, r, None, x0:x1].clamp_max(1.0),
                          fy1[:, r, y0:y1, None].clamp_max(1.0)).flatten(1)
        occ_r = occ_win[:, y0:y1, x0:x1].flatten(1)
        a = torch.where(occ_r & (a <= b), a, _INF)
        t_rows.append(torch.nn.functional.pad(a, (0, m - a.shape[1]), value=_INF))
    t_hit = torch.stack(t_rows, 1).amin(-1)  # (N, R)
    return _pull_back(t_hit, seg, eps), t_hit


def windowed_window(occ: torch.Tensor, origin: torch.Tensor, radius: int,
                    pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """apx's ``raycast_grid_windowed`` window: the (2 radius + 2)^2 cells
    around ``floor(origin)`` of the map padded by ``pad`` (a dynamic slice),
    and its base ``floor(origin) - radius`` (N, 2) f32 in map coordinates."""
    win = 2 * radius + 2
    base = torch.floor(origin.to(torch.float32)) - radius
    starts = (base + pad).to(torch.int32)
    return cut_windows(occ, starts, pad, win, win), base


def raycast_grid_windowed(occ: torch.Tensor, pad: int, origin: torch.Tensor,
                          targets: torch.Tensor, radius: int, eps: float = EPS,
                          geos_typing: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """``raycast_grid`` on the (2 radius + 2)^2 window around each origin
    (``windowed_window``), in the window frame (``origin - base``,
    ``targets - base``): valid when every segment's per-axis extent is at
    most radius - 1."""
    win, base = windowed_window(occ, origin, radius, pad)
    return raycast_grid(win, origin - base, targets - base[:, None, :], eps=eps,
                        geos_typing=geos_typing)


def contact_cells(origin: torch.Tensor, targets: torch.Tensor, distances: torch.Tensor,
                  tol: float = 1e-5) -> torch.Tensor:
    """(N, R, 2) int32 cells of each beam's contact point, or -1 on a miss,
    with the reference's pull-back of a coordinate that lands exactly on a
    boundary while travelling negative."""
    o = origin.to(torch.float32)[:, None, :]
    d = targets.to(torch.float32) - o
    seg = seg_length(d)[..., None]
    unit = d / torch.where(seg == 0.0, 1.0, seg)
    contact = fma(unit, distances[..., None], o)
    coords = torch.floor(contact)
    exact = (coords - contact).abs() < tol
    coords = torch.where(exact & (targets < o), coords - 1.0, coords)
    miss = distances[..., None] >= seg
    return torch.where(miss, -1, coords.to(torch.int32)).to(torch.int32)


def extract_window_mxu(occ: torch.Tensor, pad: int, origin: torch.Tensor,
                       win: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, win, win) bool windows around each origin by one-hot products
    (apx's MXU form), and their bases ``floor(origin) - (win // 2 - 1)``
    (N, 2) f32. The products select from the unpadded map: a row or column
    outside it selects nothing, as the padding's zeros do in apx. The 0/1
    sums are exact in bfloat16."""
    n, h, w = occ.shape
    base = torch.floor(origin.to(torch.float32)) - (win // 2 - 1)
    start = (base + pad).to(torch.int32).to(torch.int64) - pad  # first map row / column
    dev, bf = occ.device, torch.bfloat16
    i = torch.arange(win, device=dev)
    rsel = (start[:, 1, None, None] + i[:, None]) == torch.arange(h, device=dev)  # (N, win, H)
    csel = (start[:, 0, None, None] + i[:, None]) == torch.arange(w, device=dev)  # (N, win, W)
    prod = torch.matmul(torch.matmul(rsel.to(bf), occ.to(bf)), csel.to(bf).transpose(1, 2))
    return prod > 0.5, base


def lidar_table_scan(face: torch.Tensor, axis_x: torch.Tensor, bank_pos: torch.Tensor,
                     pos: torch.Tensor, dirs_scaled: torch.Tensor, eps: float = EPS,
                     signs: torch.Tensor | None = None) -> torch.Tensor:
    """(N, 8) distances of the 8-beam scan as one table lookup per beam:
    ``face`` (M, 8, 2, H, W) f32 holds the first wall face each beam meets
    from each cell under each staircase variant, ``axis_x`` whether it is an
    x face (``data.floor_map.build_beam_tables``). The hit parameter
    ``(face - p) * inv`` is the dense cast's expression for that face, so
    the distances equal the dense fast cast's away from exact lattice-corner
    events. ``signs`` is ``BEAM_SIGNS`` on the device (made here if not
    given; a caller inside a CUDA graph capture passes it)."""
    from ..data.floor_map import BEAM_SIGNS

    _, nb, _, h, w = face.shape
    p = pos.to(torch.float32)
    d = (p[:, None, :] + dirs_scaled.to(torch.float32)) - p[:, None, :]  # (N, 8, 2)
    seg = seg_length(d)
    zero = d == 0.0
    inv = torch.where(zero, _INF, torch.reciprocal(torch.where(zero, 1.0, d)))
    fl = torch.floor(p)
    cx = fl[:, 0].to(torch.int64).clamp(0, w - 1)
    cy = fl[:, 1].to(torch.int64).clamp(0, h - 1)
    fx, fy = p[:, 0] - fl[:, 0], p[:, 1] - fl[:, 1]
    if signs is None:
        signs = torch.from_numpy(BEAM_SIGNS).to(p.device)
    sx, sy = signs[:, 0], signs[:, 1]
    # The staircase variant: which grid crossing a diagonal beam meets
    # first (|dx| == |dy| bitwise, so a comparison of fractions).
    tx = torch.where(sx > 0, 1.0 - fx[:, None], fx[:, None])
    ty = torch.where(sy > 0, 1.0 - fy[:, None], fy[:, None])
    v = torch.where((sx != 0) & (sy != 0), (tx >= ty).to(torch.int64), 0)  # (N, 8)
    b = torch.arange(nb, device=p.device)
    flat = (((bank_pos.to(torch.int64)[:, None] * nb + b) * 2 + v) * h + cy[:, None]) * w \
        + cx[:, None]
    face_v = face.reshape(-1)[flat]
    ax_v = axis_x.reshape(-1)[flat]
    t = torch.where(ax_v, (face_v - p[:, 0:1]) * inv[..., 0], (face_v - p[:, 1:2]) * inv[..., 1])
    return torch.where(t <= 1.0, fma(t, seg, -eps).clamp_min(0.0), seg)
