"""L, LightDark's step and its reset's observation, each as one
hand-written CUDA launch (``apx_torch/csrc/light_dark.cu``).

* ``step``: ``envs.light_dark.step_plain`` (the move, the wall test, the
  clip, the noisy observation, the base reward, ``truncated``);
* ``reset``: ``envs.light_dark.noisy_position``, the noisy observation of
  the drawn positions.

The env calls them on CUDA tensors and runs the plain forms on the CPU
(the plain forms stay in the env's module, whose rounding sites the
tests replace one at a time). The wrappers launch or raise, as S's and
R's do on the card: a leaf of another shape, dtype or layout (each
(N, 2) float32 leaf contiguous and 8-byte aligned, for the kernel's
float2 loads), operands on two devices or on the CPU, or an operand that
requires grad under grad mode (L has no backward) raise, and nothing
falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ._launch import entry, need, one_device

__all__ = ["step", "reset"]

# The most envs a launch takes: the kernel's block count (n + 255) / 256
# and its thread index are ints.
MAX_N = 2**31 - 256


def _leaves(kernel: str, n: int, **xs: torch.Tensor) -> list[int]:
    """The data pointers of the (N, 2) float32 leaves ``xs``, after
    checking their shape, dtype, layout and alignment."""
    ptrs = []
    for name, x in xs.items():
        ptr = need(kernel, name, x, (n, 2))
        if ptr % 8:
            raise ValueError(f"{kernel}: {name} must be 8-byte aligned, got address {ptr:#x}")
        ptrs.append(ptr)
    return ptrs


def _n(kernel: str, pos: torch.Tensor) -> int:
    if not isinstance(pos, torch.Tensor) or pos.ndim != 2 or pos.shape[0] > MAX_N:
        got = tuple(pos.shape) if isinstance(pos, torch.Tensor) else type(pos).__name__
        raise ValueError(f"{kernel}: pos must be (N, 2) with N <= {MAX_N}, got {got}")
    return pos.shape[0]


_ptr, _f32 = ctypes.c_void_p, ctypes.c_float
_STEP = entry("L", "light_dark_step_launch",
              [*[_ptr] * 3, *[_f32] * 5, ctypes.c_int, *[_ptr] * 5])


def step(pos: torch.Tensor, action: torch.Tensor, noise: torch.Tensor,
         light: tuple[float, float], h2: float, move_scale: float,
         scale: float) -> tuple[torch.Tensor, ...]:
    """(position, observation, base reward, terminated, truncated) of
    ``step_plain``; ``light``, ``h2``, ``move_scale`` and ``scale`` float32
    values, passed by value."""
    kernel = "light_dark_step"
    n = _n(kernel, pos)
    ptrs = _leaves(kernel, n, pos=pos, action=action, noise=noise)
    dev = one_device(kernel, pos, action, noise)
    out = (torch.empty((n, 2), device=dev), torch.empty((n, 2), device=dev),
           torch.empty(n, device=dev), torch.empty(n, dtype=torch.bool, device=dev),
           torch.empty(n, dtype=torch.bool, device=dev))
    _STEP(dev, *ptrs, *(_f32(v) for v in (*light, h2, move_scale, scale)), n,
          *(x.data_ptr() for x in out))
    return out


_RESET = entry("L", "light_dark_reset_launch", [_ptr, _ptr, *[_f32] * 4, ctypes.c_int, _ptr])


def reset(pos: torch.Tensor, noise: torch.Tensor, light: tuple[float, float], h2: float,
          scale: float) -> torch.Tensor:
    """``noisy_position(pos, noise, scale, ...)``: the (N, 2) observation."""
    kernel = "light_dark_reset"
    n = _n(kernel, pos)
    ptrs = _leaves(kernel, n, pos=pos, noise=noise)
    dev = one_device(kernel, pos, noise)
    obs = torch.empty((n, 2), device=dev)
    _RESET(dev, *ptrs, *(_f32(v) for v in (*light, h2, scale)), n, obs.data_ptr())
    return obs
