"""The least time the card could take for a function of the port, at the
cell's shapes and inputs: the larger of its bytes at the HBM rate and its
operations at the float32 rates (``peaks``).

The bytes are what the function's contract needs: each input read once and
each output written once; a boolean map counts one bit a cell. The
operations are counted as the port's own bound arithmetic counts them
(``chip_smoke.py``'s ``OPS_PER_CELL``, ``LIDAR_STEP_OPS``, ``glimpse_bound``,
copied here): a cast's instructions over the cells that can hold its hit,
the step's float32 operations, the glimpse's taps and outputs. Neither
depends on how a kernel lays out its state or how many launches it takes,
so no layout or fusion can read above its bound.
"""

from __future__ import annotations

import math

import torch

from .peaks import FP32_ISSUE_PER_S, FP32_OPS_PER_S, HBM_BYTES_PER_S

__all__ = ["OPS_PER_CELL", "LIDAR_STEP_OPS", "OPS_PER_GLIMPSE_U8", "OPS_PER_GLIMPSE_TAP",
           "candidate_cells", "lidar_step_bytes", "lidar_step_least_s", "glimpse_footprint",
           "glimpse_bytes", "glimpse_least_s"]

# Instructions per (ray, candidate cell) of a slab cast: max, min, compare,
# and, select, min-reduce (untyped); the typed scan adds the clips, the
# crossing and graze compares and three graze reductions.
OPS_PER_CELL = {"untyped": 6, "typed": 12}
# float32 operations per env of the LIDAR step's arithmetic around its casts,
# counted from the source (an FMA 2, a root or a division 1, a compare or a
# select 1): (fixed, per beam), by stage (move, slide, clip, observation).
LIDAR_STEP_OPS = {"a": (34, 0), "b": (22, 0), "c": (30, 2), "d": (4, 3)}
# Instructions of a glimpse: per output element the 4-term bilinear, the
# clip and the conversion of its four uint8 taps; per sample row or column
# its coordinate and its tap pair.
OPS_PER_GLIMPSE_U8 = 15
OPS_PER_GLIMPSE_TAP = 20


def _slab_ok(o: torch.Tensor, d: torch.Tensor, size: int) -> torch.Tensor:
    """(N, R, size) whether each column (or row) k has a slab pair with
    near <= 1 and far >= 0 for the segments o + t d, t in [0, 1]."""
    lo = torch.arange(size, dtype=o.dtype, device=o.device)
    hi = lo + 1.0
    zero = d == 0.0
    safe = torch.where(zero, torch.ones_like(d), d)
    t1, t2 = (lo - o) / safe, (hi - o) / safe
    near, far = torch.minimum(t1, t2), torch.maximum(t1, t2)
    inside = (lo <= o) & (o <= hi)
    near = torch.where(zero, torch.where(inside, -math.inf, math.inf), near)
    far = torch.where(zero, torch.where(inside, math.inf, -math.inf), far)
    return (near <= 1.0) & (far >= 0.0)


def candidate_cells(h: int, w: int, origin: torch.Tensor, targets: torch.Tensor) -> int:
    """Cells, summed over the casts origin (N, 2) -> targets (N, R, 2), that
    can hold a hit: the hull of the columns that pass the slab test times
    the hull of the rows that do."""
    o = origin.to(torch.float64)[:, None, :]
    d = targets.to(torch.float64) - o

    def hull(size: int, axis: int) -> torch.Tensor:
        ok = _slab_ok(o[..., axis:axis + 1], d[..., axis:axis + 1], size)
        idx = torch.arange(size, device=o.device)
        first = torch.where(ok, idx, size).amin(-1)
        last = torch.where(ok, idx, -1).amax(-1)
        return (last - first + 1).clamp_min(0)

    return int((hull(w, 0) * hull(h, 1)).sum())


def lidar_step_bytes(n: int, h: int, w: int, beams: int) -> int:
    """Bytes of one LIDAR step of n envs (the move, the wall slide, the clip
    and the beam scan): reads the map (one bit a cell), the action, the
    position, the odometry origin and its flag; writes the position, the
    origin and its flag, the base reward, the two dones, the prediction
    target, the lidar readings and the odometry."""
    reads = math.ceil(h * w / 8) + 8 + 8 + 8 + 1
    writes = 8 + 8 + 1 + 4 + 1 + 1 + 8 + 4 * beams + 8
    return n * (reads + writes)


def lidar_step_least_s(n: int, h: int, w: int, beams: int, cells: int) -> float:
    """Least seconds of one LIDAR step of n envs whose three casts (the
    move, the two slide candidates, the beams) can hit ``cells`` cells in
    all (``candidate_cells``): the larger of the bytes at the HBM rate and
    the casts' per-cell instructions plus the step's float32 operations at
    the float32 rates."""
    ops_s = (cells * OPS_PER_CELL["untyped"] / FP32_ISSUE_PER_S
             + n * sum(a + b * beams for a, b in LIDAR_STEP_OPS.values()) / FP32_OPS_PER_S)
    return max(lidar_step_bytes(n, h, w, beams) / HBM_BYTES_PER_S, ops_s)


def glimpse_footprint(pos: torch.Tensor, image_hw: tuple[int, int], sensor: tuple[int, int],
                      scale: float = 1.0) -> torch.Tensor:
    """(N,) pixels per channel that the glimpses at ``pos`` (N, 2) touch:
    the distinct rows times the distinct columns with a nonzero hat weight
    (ap_gym's sensing grid: centre ``pos * lim + (size - 1) / 2``, offsets
    ``(i - (s - 1) / 2) * scale``, coordinates clipped to the image)."""
    h, w = image_hw
    p = pos.to(torch.float64)
    lim_x = (w - 1) / 2 - (sensor[0] * scale - 1) / 2
    lim_y = (h - 1) / 2 - (sensor[1] * scale - 1) / 2

    def touched(centre: torch.Tensor, s: int, size: int) -> torch.Tensor:
        offs = (torch.arange(s, dtype=torch.float64, device=p.device) - (s - 1) / 2) * scale
        c = (centre[:, None] + offs).clamp(0.0, size - 1)
        grid = torch.arange(size, dtype=torch.float64, device=p.device)
        return ((1.0 - (c[..., None] - grid).abs()) > 0).any(dim=1).sum(dim=-1)

    return touched(p[:, 1] * lim_y + (h - 1) / 2, sensor[0], h) * \
        touched(p[:, 0] * lim_x + (w - 1) / 2, sensor[1], w)


def glimpse_bytes(pos: torch.Tensor, image_hwc: tuple[int, int, int],
                  sensor: tuple[int, int], scale: float = 1.0) -> int:
    """Bytes of one glimpse launch at ``pos`` (N, 2) over uint8 images: the
    pixels its hats touch, the positions and the float32 output."""
    h, w, c = image_hwc
    n = pos.shape[0]
    pixels = int(glimpse_footprint(pos, (h, w), sensor, scale).sum())
    return pixels * c + n * 8 + n * sensor[0] * sensor[1] * c * 4


def glimpse_least_s(pos: torch.Tensor, image_hwc: tuple[int, int, int],
                    sensor: tuple[int, int], scale: float = 1.0) -> float:
    """Least seconds of one glimpse launch at ``pos`` (N, 2) over uint8
    images (H, W, C)."""
    n = pos.shape[0]
    c = image_hwc[2]
    ops = (n * sensor[0] * sensor[1] * c * OPS_PER_GLIMPSE_U8
           + n * (sensor[0] + sensor[1]) * OPS_PER_GLIMPSE_TAP)
    return max(glimpse_bytes(pos, image_hwc, sensor, scale) / HBM_BYTES_PER_S,
               ops / FP32_ISSUE_PER_S)
