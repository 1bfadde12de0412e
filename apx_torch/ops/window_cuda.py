"""K2, the per-env window gather, as a hand-written CUDA kernel for Hopper.

Replaces apx's Pallas TPU kernel ``apx/ops/window_pallas.py:70``
(``kernel`` in ``extract_windows_pallas``, batched by
``make_window_extractor``), which the TPU's DMA engines could not run on
16-lane slices. It cuts the (24, 16) window of every env's map that the
LIDAR step's casts run on under ``raycast_backend="pallas_window"``
(``apx_torch.envs.lidar_localization``). apx cuts it from a ray-padded
copy of the map; K2 reads the unpadded map and writes the padding's zeros
itself, so the port's state carries no padded copy.

What bounds it, and the design (``apx_torch/csrc/window.cu``): bytes — the
window's cells inside the map read, 24 x 16 bytes written per env, plus
the starts. One warp per env with its starts loaded and clamped once,
32-bit indices with no division per byte, whole words stored per lane,
and no load for a cell outside the map.

On a CUDA tensor ``extract_windows`` launches the kernel (building the
library on first use, ``apx_torch.ops.build``) or raises; it never falls
back to the plain form. On a CPU tensor it runs the plain form
(``apx_torch.ops.window.extract_windows``). ``LAUNCHES`` counts kernel
launches, for checks that a run really went through the kernel.
"""

from __future__ import annotations

import torch

from . import build
from ._launch import launch
from . import window as plain

__all__ = ["extract_windows", "LAUNCHES", "reset_launch_counts"]

LAUNCHES: dict[str, int] = {"window": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(occ: torch.Tensor, starts: torch.Tensor, pad: int, win: int) -> None:
    if occ.ndim != 3 or starts.ndim != 2:
        raise ValueError("expected occ (N, H, W) and starts (N, 2)")
    n, h, w = occ.shape
    if starts.shape != (n, 2):
        raise ValueError(f"shape mismatch: occ {tuple(occ.shape)}, starts {tuple(starts.shape)}")
    if h < 1 or w < 1 or pad < 0 or win < 1 or h + 2 * pad < plain.WIN_ROWS or w + 2 * pad < win:
        raise ValueError(f"a ({plain.WIN_ROWS}, {win}) window does not fit a {h}x{w} map "
                         f"padded by {pad}")
    if occ.dtype != torch.bool or starts.dtype != torch.int32:
        raise TypeError("expected occ bool and starts int32")
    if occ.device != starts.device:
        raise ValueError("occ and starts must be on one device")


def extract_windows(occ: torch.Tensor, starts: torch.Tensor, pad: int,
                    win: int = plain.WIN) -> torch.Tensor:
    """(N, 24, win) uint8 windows of ``pad_occupancy(occ, pad)`` at starts
    (N, 2) int32 = (x0, y0) in padded coordinates, brought into range as
    ``jax.lax.dynamic_slice`` brings its starts, cut from occ (N, H, W)
    bool itself (``window.extract_windows``)."""
    _check(occ, starts, pad, win)
    if occ.device.type == "cpu":
        return plain.extract_windows(occ, starts, pad, win)
    lib = build.load()
    occ = occ.contiguous()
    starts = starts.contiguous()
    if starts.data_ptr() % 8:  # the kernel reads each env's starts as one int2
        starts = starts.clone()
    n, h, w = occ.shape
    out = torch.empty((n, plain.WIN_ROWS, win), dtype=torch.uint8, device=occ.device)
    if n == 0:
        return out
    err = launch("K2", lib.window_launch, occ.data_ptr(), starts.data_ptr(), out.data_ptr(), n, h,
                 w, pad, win, torch.cuda.current_stream(occ.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window kernel launch failed: CUDA error {err}")
    LAUNCHES["window"] += 1
    return out
