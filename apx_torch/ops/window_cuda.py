"""K2, the per-env window gather, as a hand-written CUDA kernel for Hopper.

Replaces apx's Pallas TPU kernel ``apx/ops/window_pallas.py:70``
(``kernel`` in ``extract_windows_pallas``, batched by
``make_window_extractor``), which the TPU's DMA engines could not run on
16-lane slices. It cuts the (24, 16) window of every env's ray-padded map
that the LIDAR step's casts run on under ``raycast_backend="pallas_window"``
(``apx_torch.envs.lidar_localization``).

What bounds it, and the design (``apx_torch/csrc/window.cu``): bytes — 24
x 16 bytes read and written per env, plus the starts. One thread per
output byte, consecutive threads on consecutive bytes of a window row.

On a CUDA tensor ``extract_windows`` launches the kernel (building the
library on first use, ``apx_torch.ops.build``) or raises; it never falls
back to the plain form. On a CPU tensor it runs the plain form
(``apx_torch.ops.window.extract_windows``). ``LAUNCHES`` counts kernel
launches, for checks that a run really went through the kernel.
"""

from __future__ import annotations

import torch

from . import build
from . import window as plain

__all__ = ["extract_windows", "LAUNCHES", "reset_launch_counts"]

LAUNCHES: dict[str, int] = {"window": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(occ_padded: torch.Tensor, starts: torch.Tensor, win: int) -> None:
    if occ_padded.ndim != 3 or starts.ndim != 2:
        raise ValueError("expected occ_padded (N, Hp, Wp) and starts (N, 2)")
    n, hp, wp = occ_padded.shape
    if starts.shape != (n, 2):
        raise ValueError(f"shape mismatch: occ_padded {tuple(occ_padded.shape)}, "
                         f"starts {tuple(starts.shape)}")
    if hp < plain.WIN_ROWS or wp < win or win < 1:
        raise ValueError(f"a ({plain.WIN_ROWS}, {win}) window does not fit a {hp}x{wp} map")
    if occ_padded.dtype != torch.bool or starts.dtype != torch.int32:
        raise TypeError("expected occ_padded bool and starts int32")
    if occ_padded.device != starts.device:
        raise ValueError("occ_padded and starts must be on one device")


def extract_windows(occ_padded: torch.Tensor, starts: torch.Tensor,
                    win: int = plain.WIN) -> torch.Tensor:
    """(N, 24, win) uint8 windows of occ_padded (N, Hp, Wp) bool at starts
    (N, 2) int32 = (x0, y0), brought into range as ``jax.lax.dynamic_slice``
    brings its starts (``window.extract_windows``)."""
    _check(occ_padded, starts, win)
    if occ_padded.device.type == "cpu":
        return plain.extract_windows(occ_padded, starts, win)
    lib = build.load()
    occ_padded = occ_padded.contiguous()
    starts = starts.contiguous()
    n, hp, wp = occ_padded.shape
    out = torch.empty((n, plain.WIN_ROWS, win), dtype=torch.uint8, device=occ_padded.device)
    if n == 0:
        return out
    err = lib.window_launch(occ_padded.data_ptr(), starts.data_ptr(), out.data_ptr(), n, hp,
                            wp, win, torch.cuda.current_stream(occ_padded.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window kernel launch failed: CUDA error {err}")
    LAUNCHES["window"] += 1
    return out
