"""Operand checks shared by the ctypes wrappers of the LIDAR step's
kernels (F1 in ``lidar_step_cuda``, S and R in ``lidar_fused_cuda``), the
stream they launch on, and ``launch``, through which every wrapper of a
hand-written kernel makes its ctypes call. ``kernel`` names the caller in
every error."""

from __future__ import annotations

import torch

from ..core.trace import call

__all__ = ["KERNELS", "launch", "need", "one_device", "stream"]

# Each hand-written kernel by its id (PERF.md's tables) and the symbol of
# its device function, which a profiler's trace shows in the kernel's name.
KERNELS = {
    "K1": "raycast_kernel",  # raycast_cuda: raycast_fast and raycast_typed
    "K2": "window_kernel",  # window_cuda
    "K3": "glimpse_kernel",  # glimpse_cuda
    "K4": "chain_kernel",  # issue_rate_study
    "N1": "apx_fma_f32",  # core.numerics
    "N2": "apx_sum_squares_f32",
    "N3": "apx_sqrt_f32",
    "F1": "apx_lidar_step_",  # lidar_step_cuda: stages a to d
    "F2": "apx_merge_next_step",  # merge_cuda
    "S": "apx_lidar_fused_step",  # lidar_fused_cuda
    "R": "apx_lidar_fused_reset",
    "L": "apx_light_dark",  # light_dark_cuda: apx_light_dark_step and apx_light_dark_reset
}


def need(kernel: str, name: str, x: torch.Tensor, shape: tuple, dtype=torch.float32) -> int:
    """x's data pointer, after checking it is a contiguous tensor of this
    shape and dtype."""
    if not isinstance(x, torch.Tensor) or x.dtype != dtype or tuple(x.shape) != tuple(shape):
        got = (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else type(x).__name__
        raise ValueError(f"{kernel}: {name} must be {tuple(shape)} {dtype}, got {got}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous, got strides {x.stride()}")
    return x.data_ptr()


def one_device(kernel: str, *xs: torch.Tensor) -> torch.device:
    """The one CUDA device of ``xs``; raises on mixed or CPU devices and on
    an operand that requires grad under grad mode (the kernel has no
    backward)."""
    dev = xs[0].device
    if dev.type != "cuda" or any(x.device != dev for x in xs):
        raise ValueError(f"{kernel}: operands on {sorted({str(x.device) for x in xs})}, "
                         "expected one CUDA device")
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise ValueError(f"{kernel}: an operand requires grad and the kernel has no backward: "
                         "detach the action")
    return dev


def stream(dev: torch.device) -> int:
    """The handle of ``dev``'s current CUDA stream."""
    return torch.cuda.current_stream(dev).cuda_stream


def launch(kernel: str, fn, *args) -> int:
    """``fn(*args)``, the ctypes launch of the kernel ``kernel`` (a key of
    ``KERNELS``), inside the span ``kernel.<id>``: its return code."""
    return call("kernel." + kernel, fn, *args)
