"""The launch seam of the port's hand-written kernels, and the operand
checks their ctypes wrappers share.

A wrapper declares each C entry of the kernel library (``ops.build``) it
calls once, at module level, beside the call that uses it, and launches
through it:

    _WINDOW = entry("K2", "window_launch", [ptr, ptr, ptr, *[c_int] * 5])
    ...
    _WINDOW(occ.device, occ.data_ptr(), ...)

The first call binds the C signature (``argtypes``, the stream, an int
return) on the library, built on first use. Every call passes the
device's current stream last and makes the ctypes call inside the span
``kernel.<id>`` (``core.trace``), raises when it returns a CUDA error, and
otherwise counts one launch in the process's launch table under
``"<id>.<C name>"``. ``launches()`` copies the table, ``launched(key)``
reads one entry or one kernel's entries, ``clear_launches()`` zeroes it.
Checks that a run really went through a kernel read the table; a replayed
CUDA graph runs no Python and counts nothing.

``need`` and ``one_device`` are the wrappers' operand checks; ``kernel``
names the caller in every error."""

from __future__ import annotations

import ctypes

import torch

from ..core.trace import call
from . import build

__all__ = ["KERNELS", "entry", "launches", "launched", "clear_launches", "need", "one_device"]

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
    "M": "apx_image_move",  # image_move_cuda
    "P": "apx_loss_",  # loss_cuda: apx_loss_cross_entropy and apx_loss_mse
}

_TABLE: dict[str, int] = {}  # "<id>.<C name>" of every declared entry -> launches


class entry:
    """The launch of the C function ``name`` of kernel ``kernel`` (a key of
    ``KERNELS``), whose parameters are ``argtypes`` and then the CUDA
    stream, as every entry's are. Calling it with a CUDA device and the
    other arguments launches on the device's current stream (see the
    module's docstring) and returns None. ``fn`` is the bound function:
    None until the first call, and a test may set a stand-in."""

    __slots__ = ("kernel", "name", "key", "argtypes", "fn", "_span")

    def __init__(self, kernel: str, name: str, argtypes):
        if kernel not in KERNELS:
            raise ValueError(f"{name}: kernel id {kernel!r} is not one of {sorted(KERNELS)}")
        self.kernel, self.name, self.key = kernel, name, f"{kernel}.{name}"
        self.argtypes, self.fn, self._span = [*argtypes, ctypes.c_void_p], None, "kernel." + kernel
        _TABLE.setdefault(self.key, 0)

    def __call__(self, dev: torch.device, *args) -> None:
        fn = self.fn
        if fn is None:
            fn = self.fn = getattr(build.load(), self.name)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
        err = call(self._span, fn, *args, stream(dev))
        if err != 0:
            raise RuntimeError(
                f"{self.kernel} ({self.name}): kernel launch failed: CUDA error {err}")
        _TABLE[self.key] += 1


def launches() -> dict[str, int]:
    """A copy of the launch table: each declared entry's launches since the
    last ``clear_launches()``, keyed ``"<id>.<C name>"``."""
    return dict(_TABLE)


def launched(key: str, table: dict[str, int] | None = None) -> int:
    """The launches of one entry (``"K1.raycast_fast_launch"``) or of every
    entry of one kernel id (``"K3"``): in the launch table since the last
    ``clear_launches()``, or in ``table``, a copy of it (one that leaves
    out entries never launched, as a report may)."""
    kernel, _, name = key.partition(".")
    if kernel not in KERNELS or (name and table is None and key not in _TABLE):
        raise KeyError(f"{key!r} is neither a kernel id nor a declared entry")
    table = _TABLE if table is None else table
    if name:
        return table.get(key, 0)
    return sum(n for k, n in table.items() if k.partition(".")[0] == key)


def clear_launches() -> None:
    """Zero every count of the launch table."""
    for key in _TABLE:
        _TABLE[key] = 0


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
