"""M, the image envs' move and the step observation around the glimpse,
as one hand-written CUDA launch (``apx_torch/csrc/image_move.cu``).

``move`` computes, per env, what ``envs.image_perception``'s
``ImagePerceptionEngine.move`` and ``observe`` compute besides the
glimpse: the projected, scaled and clipped move, the base reward, the
time and its observation, ``terminated``, ``truncated`` (false) and,
where labels are randomly inverted, the inverted-label observation.

The engine calls it on CUDA tensors and runs the plain forms on the CPU
(they stay in the engine's module, whose rounding sites the tests replace
one at a time). The wrapper launches or raises, as L's does on the card:
a leaf of another shape, dtype or layout (``pos`` and ``action`` (N, 2)
float32, contiguous and 8-byte aligned, for the kernel's float2 loads;
``time`` (N,) int32; ``label_inverted`` (N,) bool), operands on two
devices or on the CPU, a step limit outside int32, or an operand that
requires grad under grad mode (M has no backward) raise, and nothing
falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._launch import entry, need, one_device

__all__ = ["move"]

KERNEL = "image_move"
# The most envs a launch takes: the kernel's block count (n + 255) / 256
# and its thread index are ints.
MAX_N = 2**31 - 256
INT32 = np.iinfo(np.int32)

_ptr, _f32 = ctypes.c_void_p, ctypes.c_float
_MOVE = entry("M", "image_move_launch",
              [*[_ptr] * 4, _f32, _f32, ctypes.c_int, _f32, ctypes.c_int, *[_ptr] * 7])


def move(pos: torch.Tensor, action: torch.Tensor, time: torch.Tensor,
         label_inverted: torch.Tensor | None, max_step: tuple[float, float],
         step_limit: int) -> tuple[torch.Tensor | None, ...]:
    """(position, time, base reward, terminated, truncated, time step,
    inverted label) of a step: the inverted label is None when
    ``label_inverted`` is (labels not randomly inverted). ``max_step`` is
    the per-axis max step, rounded to float32 as the engine's tensor of it
    is; the time observation's ``f32(1 / step_limit)`` is ``time_obs``'s."""
    if not isinstance(pos, torch.Tensor) or pos.ndim != 2 or pos.shape[0] > MAX_N:
        got = tuple(pos.shape) if isinstance(pos, torch.Tensor) else type(pos).__name__
        raise ValueError(f"{KERNEL}: pos must be (N, 2) with N <= {MAX_N}, got {got}")
    n = pos.shape[0]
    ptrs = []
    for name, x in (("pos", pos), ("action", action)):
        ptr = need(KERNEL, name, x, (n, 2))
        if ptr % 8:
            raise ValueError(f"{KERNEL}: {name} must be 8-byte aligned, got address {ptr:#x}")
        ptrs.append(ptr)
    ptrs.append(need(KERNEL, "time", time, (n,), torch.int32))
    inverted = label_inverted is not None
    ops = (pos, action, time)
    if inverted:
        ptrs.append(need(KERNEL, "label_inverted", label_inverted, (n,), torch.bool))
        ops += (label_inverted,)
    else:
        ptrs.append(None)
    if not INT32.min <= step_limit <= INT32.max:
        raise ValueError(f"{KERNEL}: step_limit must be an int32, got {step_limit}")
    dev = one_device(KERNEL, *ops)
    inv_limit = float(np.float32(1.0) / np.float32(step_limit))
    out = (torch.empty((n, 2), device=dev), torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, device=dev), torch.empty(n, dtype=torch.bool, device=dev),
           torch.empty(n, dtype=torch.bool, device=dev), torch.empty(n, device=dev),
           torch.empty(n, dtype=torch.int32, device=dev) if inverted else None)
    _MOVE(dev, *ptrs, *(_f32(v) for v in max_step), int(step_limit), _f32(inv_limit), n,
          *(None if x is None else x.data_ptr() for x in out))
    return out
