"""K1, the slab raycast, as a hand-written CUDA kernel for Hopper.

Replaces apx's Pallas TPU kernel ``apx/ops/raycast_pallas.py`` (``_kernel``,
launched by ``raycast_grid_pallas`` / ``raycast_grid_pallas_batch``), and
carries every cast of the LIDAR env step:

* ``raycast_fast(occ, origin, targets)``: the untyped dense slab cast,
  equal to ``raycast.raycast_grid(geos_typing=False)``;
* ``raycast_typed(occ, origin, targets)``: the GEOS-typed reset scan,
  equal to ``raycast.raycast_grid(geos_typing=True)``.

What bounds it, and the design (``apx_torch/csrc/raycast_slab.cu``):
instruction issue — the per-cell slab test is a few min/max/compare
instructions, and the bytes (the map once, the segments, the output) take
less time. One warp per env casts all its rays: the map is packed into
bits in shared memory once, each ray's reciprocals are computed once, and
each ray tests only the cells whose column and row slab pairs can hold a
candidate (near <= 1, far >= 0), 32 cells per pass whatever the map's
width. A cell outside them fails ``a <= b`` exactly, so the result stays
bitwise the plain form's; for a segment inside the map they lie in its
bounding box with a one-cell margin. The first design tested every cell
of the map with one warp per ray and one lane per column.

Like K1 (its ``len`` input), the kernels take the segment lengths from the
caller: the jitted reference rounds |d| differently at different call
sites (``apx_torch.envs.lidar_localization``), and the caller knows which
rounding its site has. A caller that passes none gets the contracted form
``raycast.seg_length(targets - origin)``: on the card the kernel computes
it per ray in its own body, on the CPU the plain form computes it first.

On a CUDA tensor each wrapper launches its kernel (building the library
on first use, ``apx_torch.ops.build``) or raises; it never falls back to
the plain form. On a CPU tensor it runs the plain form. ``LAUNCHES``
counts kernel launches per kernel name, for checks that a run really went
through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from ._launch import launch
from .raycast import EPS, raycast_grid, seg_length

__all__ = ["raycast_fast", "raycast_typed", "LAUNCHES", "reset_launch_counts"]

LAUNCHES: dict[str, int] = {"raycast_fast": 0, "raycast_typed": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _seg(occ, origin, targets, seg):
    """The lengths to cast with: None on the card when the caller gives
    none (the kernel computes them), ``seg_length`` on the CPU."""
    _check(occ, origin, targets)
    if seg is None:
        return seg_length(targets - origin[:, None, :]) if occ.device.type == "cpu" else None
    if seg.shape != targets.shape[:2] or seg.dtype != torch.float32 or seg.device != occ.device:
        raise ValueError("seg must be (N, R) float32 on the casts' device")
    return seg


def _check(occ, origin, targets):
    if occ.ndim != 3 or origin.ndim != 2 or targets.ndim != 3:
        raise ValueError("expected occ (N, H, W), origin (N, 2), targets (N, R, 2)")
    n, h, w = occ.shape
    if origin.shape != (n, 2) or targets.shape[0] != n or targets.shape[2] != 2:
        raise ValueError(
            f"shape mismatch: occ {tuple(occ.shape)}, origin {tuple(origin.shape)}, "
            f"targets {tuple(targets.shape)}"
        )
    if h > 32 or w > 32:
        raise ValueError(f"the kernel takes maps of at most 32x32 cells, got {h}x{w}")
    if occ.dtype != torch.bool or origin.dtype != torch.float32 or targets.dtype != torch.float32:
        raise TypeError("expected occ bool, origin and targets float32")
    if not (occ.device == origin.device == targets.device):
        raise ValueError("occ, origin and targets must be on one device")


def _launch(name: str, occ, origin, targets, seg, eps: float) -> torch.Tensor:
    lib = build.load()
    occ = occ.contiguous()
    origin = origin.contiguous()
    targets = targets.contiguous()
    seg = None if seg is None else seg.contiguous()
    n, h, w = occ.shape
    r = targets.shape[1]
    out = torch.empty((n, r), dtype=torch.float32, device=occ.device)
    if n * r == 0:
        return out
    stream = torch.cuda.current_stream(occ.device).cuda_stream
    err = launch(
        "K1", getattr(lib, f"{name}_launch"), occ.data_ptr(), origin.data_ptr(),
        targets.data_ptr(), None if seg is None else seg.data_ptr(), out.data_ptr(), n, r, h, w,
        ctypes.c_float(eps), stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def raycast_fast(occ: torch.Tensor, origin: torch.Tensor, targets: torch.Tensor,
                 seg: torch.Tensor | None = None, eps: float = EPS) -> torch.Tensor:
    """(N, R) distances of the untyped slab cast; occ (N, H, W) bool,
    origin (N, 2) f32, targets (N, R, 2) f32, seg (N, R) f32 the segment
    lengths (default ``raycast.seg_length(targets - origin)``, computed in
    the kernel on the card)."""
    seg = _seg(occ, origin, targets, seg)
    if occ.device.type == "cpu":
        return raycast_grid(occ, origin, targets, seg, eps=eps, geos_typing=False)[0]
    return _launch("raycast_fast", occ, origin, targets, seg, eps)


def raycast_typed(occ: torch.Tensor, origin: torch.Tensor, targets: torch.Tensor,
                  seg: torch.Tensor | None = None, eps: float = EPS) -> torch.Tensor:
    """(N, R) distances of the GEOS-typed slab cast (reset scans)."""
    seg = _seg(occ, origin, targets, seg)
    if occ.device.type == "cpu":
        return raycast_grid(occ, origin, targets, seg, eps=eps, geos_typing=True)[0]
    return _launch("raycast_typed", occ, origin, targets, seg, eps)
