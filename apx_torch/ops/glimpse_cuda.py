"""K3, the bilinear glimpse, as a hand-written CUDA kernel for Hopper.

Replaces apx's Pallas TPU kernel ``apx/ops/glimpse_pallas.py:73``
(``_kernel``, launched by ``glimpse_batch_lane_major``), which apx gates to
uint8 banks on a TPU and otherwise computes with einsums
(``extract_glimpse_batch``). Here the kernel is the glimpse on the card for
every image env, for both bank dtypes: uint8 (divided by 255 on read) and
float32 (CircleSquare's bank).

What bounds it, and the design (``apx_torch/csrc/glimpse.cu``): bytes —
the sensor's pixel footprint, the positions and the output. Each output
reads only the <= 2 x 2 pixels its bilinear hat touches, where the TPU
kernel had to reduce densely over every row and column. One warp per env,
one lane per (column, channel) of a sample row: a lane's column taps stay
in registers, a row's taps are issued once per warp, loads and stores are
coalesced, and a uint8 pixel becomes exactly ``x / 255`` in three
instructions instead of an IEEE division. The first design (one thread
per output element, 64-bit index divisions, every hat recomputed) lost to
``grid_sample`` at TinyImageNet's geometry; this one does not (PERF.md).

An optional ``index`` (N,) int64 makes glimpse n read image ``index[n]``
of ``images`` (M, H, W, C): a bank row per env (``image_storage=
"gather"``) or one image for many glimpses (the chunked unique-target
sampler), with no copy of the images.

On a CUDA tensor ``glimpse`` launches the kernel (building the library on
first use, ``apx_torch.ops.build``) or raises; it never falls back to the
plain form. On a CPU tensor it runs the plain form
(``apx_torch.ops.glimpse.extract_glimpse_batch``).
"""

from __future__ import annotations

import ctypes

import torch

from ._launch import entry
from .glimpse import extract_glimpse_batch, sensor_pos_lim_pixels

__all__ = ["glimpse"]


def _check(images: torch.Tensor, pos: torch.Tensor, sensor_size, index) -> None:
    if images.ndim != 4 or pos.ndim != 2 or pos.shape[1:] != (2,):
        raise ValueError("expected images (N, H, W, C) and pos (N, 2)")
    if index is None:
        if pos.shape[0] != images.shape[0]:
            raise ValueError(f"shape mismatch: images {tuple(images.shape)}, "
                             f"pos {tuple(pos.shape)}")
    elif index.shape != pos.shape[:1] or index.dtype != torch.int64 \
            or index.device != images.device:
        raise ValueError("index must be (N,) int64 on the images' device")
    if len(sensor_size) != 2 or min(sensor_size) < 1:
        raise ValueError(f"sensor_size must be two positive ints, got {sensor_size}")
    if images.dtype not in (torch.uint8, torch.float32) or pos.dtype != torch.float32:
        raise TypeError("expected images uint8 or float32, pos float32")
    if images.device != pos.device:
        raise ValueError("images and pos must be on one device")


_ptr, _f32 = ctypes.c_void_p, ctypes.c_float
_ENTRIES = {dtype: entry("K3", f"glimpse_{name}_launch",
                         [*[_ptr] * 4, *[ctypes.c_int] * 6, _f32, _f32, _f32])
            for dtype, name in ((torch.uint8, "u8"), (torch.float32, "f32"))}


def glimpse(images: torch.Tensor, pos: torch.Tensor, sensor_size: tuple[int, int],
            sensor_scale: float = 1.0, index: torch.Tensor | None = None) -> torch.Tensor:
    """(N, s0, s1, C) float32 glimpses at normalized positions pos (N, 2) =
    (x, y) of images (N, H, W, C) uint8 or float32, or, with ``index`` (N,)
    int64, of images[index] for images (M, H, W, C); the caller keeps the
    index in [0, M)."""
    sensor_size = tuple(int(s) for s in sensor_size)
    _check(images, pos, sensor_size, index)
    if images.device.type == "cpu":
        return extract_glimpse_batch(images if index is None else images[index], pos,
                                     sensor_size, sensor_scale)
    images = images.contiguous()
    pos = pos.contiguous()
    n = pos.shape[0]
    _, h, w, c = images.shape
    s0, s1 = sensor_size
    out = torch.empty((n, s0, s1, c), dtype=torch.float32, device=images.device)
    if out.numel() == 0:
        return out
    lim = sensor_pos_lim_pixels((h, w), sensor_size, sensor_scale)
    _ENTRIES[images.dtype](
        images.device, images.data_ptr(), pos.data_ptr(),
        None if index is None else index.contiguous().data_ptr(), out.data_ptr(), n, h, w, c, s0,
        s1, _f32(float(lim[0])), _f32(float(lim[1])), _f32(float(sensor_scale)))
    return out
