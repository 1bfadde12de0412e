"""S and R, the LIDAR env's step and reset on the whole map, each as one
hand-written CUDA launch (``apx_torch/csrc/lidar_fused.cu``).

* ``step``: kernel S, F1's four stages and K1's three casts (the move, the
  two wall-slide candidates, the beams) in one warp per env over the map
  packed into bits once; equal to ``lidar_fused.step_plain``;
* ``reset``: kernel R, from the bank's row words and spawn cells (read
  from the bank by R itself, or gathered by ``MapBank.spawn``): the
  ``occ`` leaf, the position, the reset scan and the observation, for
  every env or for those a mask selects; equal to
  ``lidar_fused.reset_plain`` on the envs it computes.

``LIDARLocalizationEnv`` calls them where every cast of the step (S), or
the reset scan (R), runs on the whole map. On CPU tensors they run the
plain forms; on CUDA tensors the kernel (the library is built on first
use, ``apx_torch.ops.build``), or an error: a wrong dtype, shape, layout
or device raises, and so does an action that requires grad under grad
mode (S has no backward: detach the action). Nothing falls back.

R's launches given a mask add to its device counter
(``core.trace.reset_counter``): the envs asked (N) and the envs computed.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import trace
from . import lidar_fused
from ._launch import entry, need, one_device
from .raycast import EPS

__all__ = ["step", "reset"]

_ptr, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _check_map(h: int, w: int, kernel: str) -> None:
    if not (1 <= h <= 32 and 1 <= w <= 32):
        raise ValueError(f"{kernel}: maps of 1 to 32 cells a side, got {h}x{w}")


_STEP = entry("S", "lidar_fused_step_launch",
               [*[_ptr] * 8, _i32, _f32, _f32, _i32, _i32, _i32, *[_ptr] * 9])


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
    _STEP(dev, *ptrs, beams, _f32(inv_range), _f32(EPS), n, h, w,
          *(x.data_ptr() for x in out.values()))
    return out


_RESET = entry("R", "lidar_fused_reset_launch",
               [*[_ptr] * 5, _i32, _i32, _ptr, _ptr, _ptr, _i32, _f32, _ptr, _f32, _i32, _i32,
                _i32, _i32, *[_ptr] * 6])


def reset(words: torch.Tensor, flat: torch.Tensor, w: int, beam_offsets: torch.Tensor,
          lidar_range: float, inv_map_size: torch.Tensor, typed: bool = True,
          only: torch.Tensor | None = None, fetch: tuple | None = None) -> dict[str, torch.Tensor]:
    """``lidar_fused.reset_plain``: words (N, H) int64, flat (N,) int64, or
    with ``fetch`` = (bank_pos, k, indices) the bank's words (M, H) and
    free cells (M, max_free), which R reads at the draws' rows and columns
    itself, adding ``map_idx``; ``only`` (N,) bool the envs to compute (the
    others' outputs are left unwritten); ``lidar_range`` is divided by as
    a float32."""
    if words.device.type == "cpu":
        return lidar_fused.reset_plain(words, flat, w, beam_offsets, lidar_range, inv_map_size,
                                       typed, only, fetch)
    kernel = "fused_reset"
    if words.ndim != 2:
        raise ValueError(f"{kernel}: words must be (N, H) or (M, H), got {tuple(words.shape)}")
    (rows, h), beams = words.shape, beam_offsets.shape[0]
    _check_map(h, w, kernel)
    words, flat = words.contiguous(), flat.contiguous()
    if fetch is None:
        n, max_free, fetched = rows, 0, ()
        src = [need(kernel, "words", words, (n, h), torch.int64),
               need(kernel, "flat", flat, (n,), torch.int64), None, None, None]
    else:
        bank_pos, k, indices = (x.contiguous() for x in fetch)
        if bank_pos.ndim != 1 or flat.ndim != 2:
            raise ValueError(f"{kernel}: bank_pos must be (N,) and flat (M, max_free), got "
                             f"{tuple(bank_pos.shape)} and {tuple(flat.shape)}")
        n, max_free, fetched = bank_pos.shape[0], flat.shape[1], (bank_pos, k, indices)
        src = [need(kernel, "words", words, (rows, h), torch.int64),
               need(kernel, "flat", flat, (rows, max_free), torch.int64),
               need(kernel, "bank_pos", bank_pos, (n,), torch.int64),
               need(kernel, "k", k, (n,), torch.int64),
               need(kernel, "indices", indices, (rows,), torch.int64)]
    masked = () if only is None else (only,)
    dev = one_device(kernel, words, flat, *fetched, *masked, beam_offsets, inv_map_size)
    mask = None if only is None else need(kernel, "only", only, (n,), torch.bool)
    counter = None if only is None else trace.reset_counter(dev)
    out = {"occ": torch.empty((n, h, w), dtype=torch.bool, device=dev),
           "pos": torch.empty((n, 2), device=dev),
           "odo_pending": torch.empty(n, dtype=torch.bool, device=dev),
           "lidar": torch.empty((n, beams), device=dev),
           "odometry": torch.empty((n, 2), device=dev)}
    map_idx = None
    if fetch is not None:
        out["map_idx"] = torch.empty(n, dtype=torch.int64, device=dev)
        map_idx = out["map_idx"].data_ptr()
    _RESET(dev, *src, rows, max_free, mask, None if counter is None else counter.data_ptr(),
           need(kernel, "beam_offsets", beam_offsets, (beams, 2)), beams, _f32(lidar_range),
           need(kernel, "inv_map_size", inv_map_size, (2,)), _f32(EPS), int(bool(typed)), n, h, w,
           *(out[k].data_ptr() for k in lidar_fused.RESET_LEAVES), map_idx)
    return out
