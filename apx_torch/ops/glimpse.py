"""Batched bilinear glimpse, plain PyTorch form (counterpart of
apx.ops.glimpse).

A glimpse samples an (s0, s1) grid of points, spaced ``sensor_scale``
pixels apart and centred at a normalized position (x, y) in [-1, 1]^2,
from an (H, W, C) image by bilinear interpolation, and clips the result to
[0, 1]. The grid is axis-aligned, so the interpolation is separable:

    glimpse = W_rows @ image @ W_cols

with ``W_rows[i, h] = max(0, 1 - |row_i - h|)``, the linear-interpolation
hat. This module computes those dense hat-weight products in apx's order
(rows, then columns, then the clip). It is what a CPU tensor runs and what
the CUDA kernel K3 (``apx_torch.ops.glimpse_cuda``) is held against.

Coordinate conventions (ap_gym's image_perception_module):
  * ``sensor_pos_lim_pixels = ([W, H] - 1) / 2 - (effective sensor - 1) / 2``,
  * sample row i / column j offsets are ``(i - (s - 1) / 2) * sensor_scale``,
  * coordinates are clipped to the image, uint8 images are divided by 255.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.numerics import div, fma, matmul_tf32

__all__ = [
    "sensor_pos_lim_pixels",
    "interp_weights",
    "glimpse_coords",
    "extract_glimpse_batch",
    "row_window",
    "PRECISIONS",
]


def sensor_pos_lim_pixels(image_hw: tuple[int, int], sensor_size: tuple[int, int],
                          sensor_scale: float) -> np.ndarray:
    """(2,) float32 position limit in pixels for (x, y): at pos = +-1 the
    effective sensor lies just inside the image. Note that the x limit pairs
    the image width with ``sensor_size[0]``, as in the reference."""
    h, w = image_hw
    eff = np.array([sensor_size[0] * sensor_scale, sensor_size[1] * sensor_scale],
                   dtype=np.float32)
    size = np.array([w, h], dtype=np.float32)
    return (size - np.float32(1.0)) / np.float32(2.0) - (eff - np.float32(1.0)) / np.float32(2.0)


def _sensor_offsets(s: int, sensor_scale: float, device=None) -> torch.Tensor:
    """(s,) float32 offsets ``(i - (s - 1) / 2) * sensor_scale``."""
    i = torch.arange(s, dtype=torch.float32, device=device)
    return (i - (s - 1) / 2.0) * float(np.float32(sensor_scale))


def glimpse_coords(pos_norm: torch.Tensor, image_hw: tuple[int, int],
                   sensor_size: tuple[int, int], sensor_scale: float):
    """Row (N, s0) and column (N, s1) sample coordinates, in array-index
    units, of the sensing grids centred at ``pos_norm`` (N, 2) = (x, y).

    The centre pixel is ``fma(pos, lim, (size - 1) / 2)``: the jitted
    reference contracts that multiply-add (``core.numerics``)."""
    h, w = image_hw
    lim = sensor_pos_lim_pixels(image_hw, sensor_size, sensor_scale)
    px, py = pos_norm[:, 0], pos_norm[:, 1]
    x_pix = fma(px, float(lim[0]), (w - 1) / 2.0)
    y_pix = fma(py, float(lim[1]), (h - 1) / 2.0)
    rows = y_pix[:, None] + _sensor_offsets(sensor_size[0], sensor_scale, pos_norm.device)
    cols = x_pix[:, None] + _sensor_offsets(sensor_size[1], sensor_scale, pos_norm.device)
    return rows, cols


def interp_weights(coords: torch.Tensor, size: int) -> torch.Tensor:
    """(..., s, size) hat weights ``max(0, 1 - |c - k|)`` of the sample
    coordinates ``coords`` (..., s), clipped to [0, size - 1]. Each row has
    at most two nonzeros."""
    c = coords.to(torch.float32).clamp(0.0, float(size - 1))
    grid = torch.arange(size, dtype=torch.float32, device=coords.device)
    return torch.clamp_min(1.0 - (c[..., None] - grid).abs(), 0.0)


PRECISIONS = ("highest", "high", "default")


def row_window(rows: torch.Tensor, h: int, sensor_rows: int,
               sensor_scale: float) -> tuple[int, torch.Tensor]:
    """apx's row band of ``window="rows"``: its height ``rwin = min(H,
    ceil((s0 - 1) scale) + 2)`` and each glimpse's first row ``r0 =
    clip(floor(min rows), 0, H - rwin)`` (N,) int64, for sample rows (N, s0)
    already clipped to [0, H - 1]. Rows outside the band carry hat weight
    exactly 0."""
    rwin = min(h, int(np.ceil((sensor_rows - 1) * sensor_scale)) + 2)
    r0 = torch.floor(rows.amin(dim=-1)).to(torch.int64).clamp(0, h - rwin)
    return rwin, r0


def extract_glimpse_batch(images: torch.Tensor, pos_norm: torch.Tensor,
                          sensor_size: tuple[int, int], sensor_scale: float = 1.0,
                          window: str = "off", precision: str | None = None) -> torch.Tensor:
    """(N, H, W, C) uint8 or float32 images, (N, 2) float32 positions ->
    (N, s0, s1, C) float32 glimpses in [0, 1].

    ``window="rows"`` (apx's row band) runs the row product over the band
    of ``row_window`` rows cut per glimpse instead of the whole image: the
    rows left out carry hat weight 0, so the result is bitwise ``"off"``'s.

    ``precision`` is apx's matmul precision of the two products (its
    ``glimpse_precision``): ``None`` (the default) float32 products under
    the caller's TF32 setting, ``"highest"`` full float32 (TF32 off on the
    card), ``"high"`` TF32 on the card (on the CPU the same as
    ``"highest"``), ``"default"`` bfloat16 inputs to each product (its
    float32 sum rounded to bfloat16 by the product, then widened)."""
    if window not in ("off", "rows"):
        raise ValueError(f"glimpse window must be 'off' or 'rows', got {window!r}")
    if precision is not None and precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    n, h, w, _ = images.shape
    rows, cols = glimpse_coords(pos_norm, (h, w), tuple(sensor_size), sensor_scale)
    if window == "rows":
        rows = rows.clamp(0.0, float(h - 1))
        rwin, r0 = row_window(rows, h, sensor_size[0], sensor_scale)
        band = r0[:, None] + torch.arange(rwin, device=images.device)
        images = images[torch.arange(n, device=images.device)[:, None], band]  # (N, rwin, W, C)
        w_rows = interp_weights(rows - r0[:, None].to(torch.float32), rwin)
    else:
        w_rows = interp_weights(rows, h)  # (N, s0, H)
    w_cols = interp_weights(cols, w)  # (N, s1, W)
    img = images.to(torch.float32)
    if images.dtype == torch.uint8:
        img = div(img, 255.0)
    if precision == "default":
        bf = torch.bfloat16
        tmp = torch.einsum("nsh,nhwc->nswc", w_rows.to(bf), img.to(bf))
        out = torch.einsum("nswc,ntw->nstc", tmp, w_cols.to(bf)).to(torch.float32)
    else:
        tf32 = contextlib.nullcontext() if precision is None else matmul_tf32(precision == "high")
        with tf32:
            tmp = torch.einsum("nsh,nhwc->nswc", w_rows, img)
            out = torch.einsum("nswc,ntw->nstc", tmp, w_cols)
    return out.clamp(0.0, 1.0)
