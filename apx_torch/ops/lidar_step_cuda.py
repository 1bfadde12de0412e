"""F1, the LIDAR step's arithmetic around K1, as four hand-written CUDA
launches (``apx_torch/csrc/lidar_step.cu``).

``LIDARLocalizationEnv.step_env`` calls ``stage_a`` .. ``stage_d`` between
its three casts; each takes and returns what the plain stage of the same
name in ``apx_torch.ops.lidar_step`` does, bitwise. Which path runs where:

* on CPU tensors, the plain stages;
* on CUDA tensors, the stage's kernel (the library is built on first use,
  ``apx_torch.ops.build``), or an error: a wrong dtype, shape, layout or
  device raises, and so does an operand that requires grad under grad
  mode (F1 has no backward: detach the action, as the training recipes
  do; apx's own gradient through a live action is NaN). Nothing falls
  back.

``LAUNCHES["lidar_step"]`` counts the kernels launched (four per step on
the card).
"""

from __future__ import annotations

import ctypes

import torch

from . import build, lidar_step
from ._launch import launch, need, one_device, stream

__all__ = ["stage_a", "stage_b", "stage_c", "stage_d", "LAUNCHES", "reset_launch_counts"]

KERNEL = "lidar_step"
LAUNCHES: dict[str, int] = {KERNEL: 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launched(err: int, stage: str) -> None:
    if err != 0:
        raise RuntimeError(f"lidar_step stage {stage} kernel launch failed: CUDA error {err}")
    LAUNCHES[KERNEL] += 1


def stage_a(action, pos, unfused_len: bool, base=None) -> dict:
    """``lidar_step.stage_a``."""
    if action.device.type == "cpu":
        return lidar_step.stage_a(action, pos, unfused_len, base)
    n = action.shape[0]
    dev = one_device(KERNEL, action, pos, *([] if base is None else [base]))
    ptrs = [need(KERNEL, "action", action, (n, 2)), need(KERNEL, "pos", pos, (n, 2)),
            None if base is None else need(KERNEL, "base", base, (n, 2))]
    out = {"base_reward": torch.empty(n, device=dev), "total": torch.empty(n, device=dev),
           "direction": torch.empty((n, 2), device=dev),
           "move_to": torch.empty((n, 1, 2), device=dev),
           "seg": torch.empty((n, 1), device=dev) if unfused_len else None}
    err = launch(
        "F1", build.load().lidar_step_a_launch, *ptrs, int(bool(unfused_len)), n,
        *(out[k].data_ptr() for k in ("base_reward", "total", "direction", "move_to")),
        None if out["seg"] is None else out["seg"].data_ptr(), stream(dev))
    _launched(err, "a")
    return out


def stage_b(pos, direction, total, d2w) -> dict:
    """``lidar_step.stage_b``."""
    if pos.device.type == "cpu":
        return lidar_step.stage_b(pos, direction, total, d2w)
    n = pos.shape[0]
    dev = one_device(KERNEL, pos, direction, total, d2w)
    ptrs = [need(KERNEL, "pos", pos, (n, 2)), need(KERNEL, "direction", direction, (n, 2)),
            need(KERNEL, "total", total, (n,)), need(KERNEL, "d2w", d2w, (n,))]
    out = {"pos1": torch.empty((n, 2), device=dev), "rem": torch.empty(n, device=dev),
           "n_keep": torch.empty(n, dtype=torch.int64, device=dev),
           "cand_diag": torch.empty((n, 2), device=dev),
           "cand": torch.empty((n, 2, 2), device=dev),
           "cand_targets": torch.empty((n, 2, 2), device=dev)}
    err = launch("F1", build.load().lidar_step_b_launch, *ptrs, n,
                 *(x.data_ptr() for x in out.values()), stream(dev))
    _launched(err, "b")
    return out


def stage_c(pos, pos1, total, rem, n_keep, cand, cand_diag, cand_dist, odo_pending,
            initial_pos, map_size, inv_map_size, beam_offsets) -> dict:
    """``lidar_step.stage_c``."""
    if pos.device.type == "cpu":
        return lidar_step.stage_c(pos, pos1, total, rem, n_keep, cand, cand_diag, cand_dist,
                                  odo_pending, initial_pos, map_size, inv_map_size, beam_offsets)
    n, beams = pos.shape[0], beam_offsets.shape[0]
    dev = one_device(KERNEL, pos, pos1, total, rem, n_keep, cand, cand_diag, cand_dist,
                     odo_pending, initial_pos, map_size, inv_map_size, beam_offsets)
    ptrs = [need(KERNEL, "pos", pos, (n, 2)), need(KERNEL, "pos1", pos1, (n, 2)),
            need(KERNEL, "total", total, (n,)), need(KERNEL, "rem", rem, (n,)),
            need(KERNEL, "n_keep", n_keep, (n,), torch.int64),
            need(KERNEL, "cand", cand, (n, 2, 2)),
            need(KERNEL, "cand_diag", cand_diag, (n, 2)),
            need(KERNEL, "cand_dist", cand_dist, (n, 2)),
            need(KERNEL, "odo_pending", odo_pending, (n,), torch.bool),
            need(KERNEL, "initial_pos", initial_pos, (n, 2)),
            need(KERNEL, "map_size", map_size, (2,)),
            need(KERNEL, "inv_map_size", inv_map_size, (2,)),
            need(KERNEL, "beam_offsets", beam_offsets, (beams, 2))]
    out = {"pos": torch.empty((n, 2), device=dev), "initial_pos": torch.empty((n, 2), device=dev),
           "odo_pending": torch.empty(n, dtype=torch.bool, device=dev),
           "terminated": torch.empty(n, dtype=torch.bool, device=dev),
           "truncated": torch.empty(n, dtype=torch.bool, device=dev),
           "target": torch.empty((n, 2), device=dev),
           "beam_targets": torch.empty((n, beams, 2), device=dev)}
    err = launch("F1", build.load().lidar_step_c_launch, *ptrs, beams, n,
                 *(x.data_ptr() for x in out.values()), stream(dev))
    _launched(err, "c")
    return out


def stage_d(dist, pos, initial_pos, inv_range: float, inv_map_size) -> dict:
    """``lidar_step.stage_d``; ``inv_range`` a float32 value, passed by
    value."""
    if dist.device.type == "cpu":
        return lidar_step.stage_d(dist, pos, initial_pos, inv_range, inv_map_size)
    n, beams = dist.shape[0], dist.shape[-1] if dist.ndim == 2 else -1
    dev = one_device(KERNEL, dist, pos, initial_pos, inv_map_size)
    ptrs = [need(KERNEL, "dist", dist, (n, beams)), need(KERNEL, "pos", pos, (n, 2)),
            need(KERNEL, "initial_pos", initial_pos, (n, 2))]
    out = {"lidar": torch.empty((n, beams), device=dev),
           "odometry": torch.empty((n, 2), device=dev)}
    err = launch(
        "F1", build.load().lidar_step_d_launch, *ptrs, ctypes.c_float(inv_range),
        need(KERNEL, "inv_map_size", inv_map_size, (2,)), beams, n, out["lidar"].data_ptr(),
        out["odometry"].data_ptr(), stream(dev))
    _launched(err, "d")
    return out
