"""Per-env occupancy windows for the LIDAR casts: the window arithmetic
and the plain PyTorch form of K2 (counterpart of apx.ops.window_pallas and
of the window part of apx's ``LIDARLocalizationEnv._make_window``).

Every cast of a step starts within 1.0 of the step's pre-move position
and reaches at most ``lidar_range`` (<= 6) cells, so a 16x16 window of the
ray-padded map around ``floor(pos)`` holds every cell a cast can meet.
apx's window starts its rows at a multiple of 8 (the TPU's sublane
tiling) and takes 24 rows, so the 16 needed rows fit whatever the
alignment offset; the window base absorbs the offset. The port keeps that
geometry, so its casts run on the same (24, 16) windows, in the same
window frame, as apx's.

apx cuts its windows from a ray-padded copy of the map that it carries as
a leaf of the env state. The padding is all zeros, so the window
cut at ``starts`` from ``pad_occupancy(occ, pad)`` is a function of the
unpadded ``occ``, ``starts`` and ``pad`` alone: ``extract_windows``
computes it from ``occ`` and the port's state carries no padded copy.

``extract_windows`` is what the CUDA kernel in ``apx_torch/csrc/window.cu``
is held to bitwise, and what runs when the tensors lie on the CPU
(``apx_torch.ops.window_cuda`` dispatches).
"""

from __future__ import annotations

import torch

__all__ = ["WIN_ROWS", "WIN", "window_starts", "extract_windows", "clamp_starts", "cut_windows"]

WIN_ROWS = 24  # an 8-aligned row start + the 16 needed rows fits any y0 % 8
WIN = 16


def window_starts(pos: torch.Tensor, win: int, ray_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Window starts and bases of positions ``pos`` (N, 2) f32, term by term
    as apx computes them (``lidar_localization.py:312-323``).

    Returns ``starts`` (N, 2) int32 = (x0, y0a), the window's first column
    and 8-aligned first row in the padded map, and ``base`` (N, 2) f32 =
    (bx, by), the map coordinates of the window's cell (0, 0): a cast runs
    in the window frame as ``origin - base``, ``targets - base``."""
    half = win // 2 - 1
    fl = torch.floor(pos.to(torch.float32))
    bx = fl[:, 0] - half
    y0 = (fl[:, 1] - half + ray_pad).to(torch.int32)
    y0a = torch.div(y0, 8, rounding_mode="floor") * 8
    by = (y0a - ray_pad).to(torch.float32)
    x0 = (bx + ray_pad).to(torch.int32)
    return torch.stack([x0, y0a], dim=-1), torch.stack([bx, by], dim=-1)


def _dynamic_slice_start(i: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``jax.lax.dynamic_slice``'s start index: a negative index counts from
    the end (``i + dim``), then the start is clamped into [0, dim - size]."""
    return torch.where(i < 0, i + dim, i).clamp(0, dim - size)


def clamp_starts(starts: torch.Tensor, hp: int, wp: int, win: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(x0, y0) brought into range as ``jax.lax.dynamic_slice`` brings its
    start indices: negative ones count from the end, then each is clamped
    into [0, wp - win] x [0, hp - WIN_ROWS]."""
    return (_dynamic_slice_start(starts[:, 0], wp, win),
            _dynamic_slice_start(starts[:, 1], hp, WIN_ROWS))


def cut_windows(occ: torch.Tensor, starts: torch.Tensor, pad: int, rows: int,
                cols: int) -> torch.Tensor:
    """(N, rows, cols) bool windows ``padded[n, y0:y0+rows, x0:x0+cols]`` of
    ``padded = pad_occupancy(occ, pad)``, computed from occ (N, H, W) bool
    without building the padded copy. starts (N, 2) = (x0, y0) are in padded
    coordinates and are first brought into range against the padded
    dimensions as ``jax.lax.dynamic_slice`` brings them; window cell (r, c)
    is then ``occ[n, y0 + r - pad, x0 + c - pad]`` where that cell lies
    inside the map, and False elsewhere."""
    n, h, w = occ.shape
    x0 = _dynamic_slice_start(starts[:, 0].to(torch.int64), w + 2 * pad, cols)
    y0 = _dynamic_slice_start(starts[:, 1].to(torch.int64), h + 2 * pad, rows)
    dev = occ.device
    r = y0[:, None] + torch.arange(-pad, rows - pad, device=dev)  # (N, rows) map rows
    c = x0[:, None] + torch.arange(-pad, cols - pad, device=dev)  # (N, cols) map columns
    inside = ((r >= 0) & (r < h))[:, :, None] & ((c >= 0) & (c < w))[:, None, :]
    env = torch.arange(n, device=dev)[:, None, None]
    return occ[env, r.clamp(0, h - 1)[:, :, None], c.clamp(0, w - 1)[:, None, :]] & inside


def extract_windows(occ: torch.Tensor, starts: torch.Tensor, pad: int,
                    win: int = WIN) -> torch.Tensor:
    """(N, WIN_ROWS, win) uint8 windows ``padded[n, y0:y0+24, x0:x0+win]``
    of ``padded = pad_occupancy(occ, pad)`` (``cut_windows``, the starts
    clamped against (H + 2 pad, W + 2 pad) as ``clamp_starts`` does)."""
    return cut_windows(occ, starts, pad, WIN_ROWS, win).to(torch.uint8)
