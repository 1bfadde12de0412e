"""S and R, the LIDAR env's step and reset on the whole map, each as one
hand-written CUDA launch (``apx_torch/csrc/lidar_fused.cu``).

* ``step``: kernel S, F1's four stages and K1's three casts (the move, the
  two wall-slide candidates, the beams) in one warp per env over the map
  packed into bits once; equal to ``lidar_fused.step_plain``;
* ``reset``: kernel R, from ``MapBank.spawn``'s row words and spawn cells:
  the ``occ`` leaf, the position, the reset scan and the observation;
  equal to ``lidar_fused.reset_plain``.

``LIDARLocalizationEnv`` calls them where every cast of the step (S), or
the reset scan (R), runs on the whole map. On CPU tensors they run the
plain forms; on CUDA tensors the kernel (the library is built on first
use, ``apx_torch.ops.build``), or an error: a wrong dtype, shape, layout
or device raises, and so does an action that requires grad under grad
mode (S has no backward: detach the action). Nothing falls back.

``LAUNCHES`` counts the kernels launched: ``fused_step`` (S) and
``fused_reset`` (R), one each per NEXT_STEP LIDAR step on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, lidar_fused
from ._launch import need, one_device, stream
from .raycast import EPS

__all__ = ["step", "reset", "LAUNCHES", "reset_launch_counts"]

LAUNCHES: dict[str, int] = {"fused_step": 0, "fused_reset": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launched(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _check_map(h: int, w: int, kernel: str) -> None:
    if not (1 <= h <= 32 and 1 <= w <= 32):
        raise ValueError(f"{kernel}: maps of 1 to 32 cells a side, got {h}x{w}")


def step(occ: torch.Tensor, action: torch.Tensor, pos: torch.Tensor,
         odo_pending: torch.Tensor, initial_pos: torch.Tensor, map_size: torch.Tensor,
         inv_map_size: torch.Tensor, beam_offsets: torch.Tensor,
         inv_range: float) -> dict[str, torch.Tensor]:
    """``lidar_fused.step_plain``; ``inv_range`` a float32 value, passed by
    value."""
    if occ.device.type == "cpu":
        return lidar_fused.step_plain(occ, action, pos, odo_pending, initial_pos, map_size,
                                      inv_map_size, beam_offsets, inv_range)
    kernel = "fused_step"
    if occ.ndim != 3:
        raise ValueError(f"{kernel}: occ must be (N, H, W), got {tuple(occ.shape)}")
    (n, h, w), beams = occ.shape, beam_offsets.shape[0]
    _check_map(h, w, kernel)
    dev = one_device(kernel, occ, action, pos, odo_pending, initial_pos, map_size,
                     inv_map_size, beam_offsets)
    ptrs = [need(kernel, "occ", occ, (n, h, w), torch.bool),
            need(kernel, "action", action, (n, 2)),
            need(kernel, "pos", pos, (n, 2)),
            need(kernel, "odo_pending", odo_pending, (n,), torch.bool),
            need(kernel, "initial_pos", initial_pos, (n, 2)),
            need(kernel, "map_size", map_size, (2,)),
            need(kernel, "inv_map_size", inv_map_size, (2,)),
            need(kernel, "beam_offsets", beam_offsets, (beams, 2))]
    out = {"pos": torch.empty((n, 2), device=dev),
           "initial_pos": torch.empty((n, 2), device=dev),
           "odo_pending": torch.empty(n, dtype=torch.bool, device=dev),
           "base_reward": torch.empty(n, device=dev),
           "terminated": torch.empty(n, dtype=torch.bool, device=dev),
           "truncated": torch.empty(n, dtype=torch.bool, device=dev),
           "target": torch.empty((n, 2), device=dev),
           "lidar": torch.empty((n, beams), device=dev),
           "odometry": torch.empty((n, 2), device=dev)}
    err = build.load().lidar_fused_step_launch(
        *ptrs, beams, ctypes.c_float(inv_range), ctypes.c_float(EPS), n, h, w,
        *(x.data_ptr() for x in out.values()), stream(dev))
    _launched(err, kernel)
    return out


def reset(words: torch.Tensor, flat: torch.Tensor, w: int, beam_offsets: torch.Tensor,
          lidar_range: float, inv_map_size: torch.Tensor,
          typed: bool = True) -> dict[str, torch.Tensor]:
    """``lidar_fused.reset_plain``: words (N, H) int64, flat (N,) int64;
    ``lidar_range`` is divided by as a float32."""
    if words.device.type == "cpu":
        return lidar_fused.reset_plain(words, flat, w, beam_offsets, lidar_range, inv_map_size,
                                       typed)
    kernel = "fused_reset"
    if words.ndim != 2:
        raise ValueError(f"{kernel}: words must be (N, H), got {tuple(words.shape)}")
    (n, h), beams = words.shape, beam_offsets.shape[0]
    _check_map(h, w, kernel)
    words, flat = words.contiguous(), flat.contiguous()
    dev = one_device(kernel, words, flat, beam_offsets, inv_map_size)
    ptrs = [need(kernel, "words", words, (n, h), torch.int64),
            need(kernel, "flat", flat, (n,), torch.int64),
            need(kernel, "beam_offsets", beam_offsets, (beams, 2))]
    out = {"occ": torch.empty((n, h, w), dtype=torch.bool, device=dev),
           "pos": torch.empty((n, 2), device=dev),
           "odo_pending": torch.empty(n, dtype=torch.bool, device=dev),
           "lidar": torch.empty((n, beams), device=dev),
           "odometry": torch.empty((n, 2), device=dev)}
    err = build.load().lidar_fused_reset_launch(
        *ptrs, beams, ctypes.c_float(lidar_range),
        need(kernel, "inv_map_size", inv_map_size, (2,)), ctypes.c_float(EPS),
        int(bool(typed)), n, h, w, *(x.data_ptr() for x in out.values()), stream(dev))
    _launched(err, kernel)
    return out
