"""Float32 arithmetic that rounds exactly as the JAX reference does.

The reference runs jitted on XLA, and XLA's CPU backend contracts a
multiply feeding an add into one fused multiply-add (FMA) inside a fusion:
``jnp.linalg.norm`` of a 2-vector is ``sqrt(fma(y, y, x*x))`` and the
jitted raycast's ``t_hit * seg - eps`` is ``fma(t_hit, seg, -eps)``. PyTorch
runs each operator as its own kernel and rounds after every one, so the
port spells those sites out with :func:`fma`. The CUDA kernels use
``__fmaf_rn`` at the same sites; both round once, so they agree bitwise.

PyTorch's float32 ``sqrt`` on the CPU is not correctly rounded (its
vectorised path is one ulp off on some inputs); :func:`sqrt` takes the
correctly rounded root.

Which path runs where: on a CUDA tensor, :func:`fma`, :func:`sum_squares`
and :func:`sqrt` each launch one hand-written kernel of
``apx_torch/csrc/numerics.cu`` (N1 ``fma_f32``, N2 ``sum_squares_f32``, N3
``sqrt_f32``; the library is built on first use, ``apx_torch.ops.build``)
or raise: they never fall back. Operands are read in place through their
strides (a slice, a ``[:, None]`` view, an expanded tensor) and a Python
float operand of :func:`fma` is passed to N1 by value, rounded to float32
on the host. On a CPU tensor they run the plain forms, which the kernels
are held to bitwise: the FMA in float64 with a round-to-odd correction
(``_fma_f64``), the root in float64 (53 >= 2 * 24 + 2 bits, so rounding it
back to float32 is the correctly rounded root). Gradients are the plain forms' on both devices:
``_FMA``'s backward, ``sum_squares`` as a chain of :func:`fma` calls when
its input requires grad, and ``_Sqrt``'s float64 backward.

Division by a Python scalar is another trap: PyTorch's CUDA ``div`` turns
``x / c`` into ``x * (1/c)`` when ``c`` is a host scalar, which is not the
correctly rounded quotient the CPU (and XLA) computes. :func:`div` divides
by a device tensor instead.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from ..ops._launch import entry

__all__ = ["fma", "sum_squares", "div", "sqrt", "time_obs", "matmul_tf32", "fma_plain",
           "sum_squares_plain", "sqrt_plain"]

MAX_DIMS = 4  # numerics.cu's kMaxDims, after merging dimensions


def _fma_f64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a*b + c``: the product of two float32
    values is exact in float64; the sum is made round-to-odd (TwoSum error
    term, then a nudge to the odd neighbour when inexact), after which the
    one rounding to float32 is the correctly rounded FMA."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.full_like(s, float("inf"))
    toward = torch.where(err > 0, inf, -inf)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


# ---- the kernels' launches (CUDA tensors) -------------------------------------


def _cuda_device(what: str, *xs) -> torch.device:
    """The one CUDA device of the tensor operands ``xs`` (float32 each)."""
    tensors = [x for x in xs if isinstance(x, torch.Tensor)]
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: operands on different devices "
                         f"{sorted({str(t.device) for t in tensors})}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what}: expected float32 operands, got "
                        f"{[str(t.dtype) for t in tensors]}")
    return dev


def _merged(shape, strides: list[tuple[int, ...]]) -> tuple[list[int], list[list[int]]]:
    """``shape`` with its size-1 dimensions dropped and each dimension merged
    into the next where every operand's strides allow it (row-major
    order kept); at least one dimension. Raises past MAX_DIMS."""
    dims = [(n, [st[d] for st in strides]) for d, n in enumerate(shape) if n != 1]
    merged: list[tuple[int, list[int]]] = []
    for n, st in dims:
        if merged and all(p == q * n for p, q in zip(merged[-1][1], st)):
            merged[-1] = (merged[-1][0] * n, st)
        else:
            merged.append((n, st))
    if not merged:
        merged = [(1, [0] * len(strides))]
    if len(merged) > MAX_DIMS:
        raise ValueError(f"shape {tuple(shape)} with these strides has {len(merged)} "
                         f"dimensions after merging; the kernels take at most {MAX_DIMS}")
    return [n for n, _ in merged], [[st[k] for _, st in merged] for k in range(len(strides))]


def _i64(values) -> ctypes.Array:
    return (ctypes.c_int64 * max(len(values), 1))(*values)


_ptr, _int, _i64p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)
_FMA_F32 = entry("N1", "fma_f32_launch",
                 [_ptr, _ptr, _ptr, *[ctypes.c_float] * 3, _int, _i64p, _i64p, _ptr])


def _launch_fma(a, b, c) -> torch.Tensor:
    """N1 on the broadcast of a, b, c (float32 tensors on one CUDA device,
    or Python floats)."""
    dev = _cuda_device("fma", a, b, c)
    ops = (a, b, c)
    shape = torch.broadcast_shapes(*(x.shape for x in ops if isinstance(x, torch.Tensor)))
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    strides = [x.expand(shape).stride() if isinstance(x, torch.Tensor) else (0,) * len(shape)
               for x in ops]
    sizes, merged = _merged(shape, strides)
    # c_float rounds a Python float to float32 as torch.full((), c, dtype=float32) does.
    _FMA_F32(dev, *(x.data_ptr() if isinstance(x, torch.Tensor) else None for x in ops),
             *(ctypes.c_float(0.0 if isinstance(x, torch.Tensor) else float(x)) for x in ops),
             len(sizes), _i64(sizes), _i64([s for st in merged for s in st]), out.data_ptr())
    return out


_SUM_SQUARES_F32 = entry("N2", "sum_squares_f32_launch",
                         [_ptr, _int, _i64p, _i64p, _int, ctypes.c_int64, _ptr])


def _launch_sum_squares(x: torch.Tensor) -> torch.Tensor:
    dev = _cuda_device("sum_squares", x)
    if x.ndim < 1 or x.shape[-1] < 1:
        raise ValueError(f"sum_squares needs a non-empty last axis, got {tuple(x.shape)}")
    shape = x.shape[:-1]
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    sizes, (strides,) = _merged(shape, [x.stride()[:-1]])
    _SUM_SQUARES_F32(dev, x.data_ptr(), len(sizes), _i64(sizes), _i64(strides), x.shape[-1],
                     x.stride(-1), out.data_ptr())
    return out


_SQRT_F32 = entry("N3", "sqrt_f32_launch", [_ptr, _int, _i64p, _i64p, _ptr])


def _launch_sqrt(x: torch.Tensor) -> torch.Tensor:
    dev = _cuda_device("sqrt", x)
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    sizes, (strides,) = _merged(x.shape, [x.stride()])
    _SQRT_F32(dev, x.data_ptr(), len(sizes), _i64(sizes), _i64(strides), out.data_ptr())
    return out


# ---- the public forms ------------------------------------------------------------


class _FMA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        return _fma_f64(a, b, c) if a.device.type == "cpu" else _launch_fma(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return g * b, g * a, g


def _on_cuda(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) and x.device.type == "cuda" for x in xs)


def fma_plain(a, b, c) -> torch.Tensor:
    """The plain form of :func:`fma` on any device: the float64 emulation,
    or ``_FMA`` when an operand requires grad (whose forward is N1 on the
    card)."""
    ref = next((x for x in (a, b, c) if isinstance(x, torch.Tensor)), None)
    if ref is None:
        raise TypeError("fma needs at least one tensor operand")
    a, b, c = (x if isinstance(x, torch.Tensor) else
               torch.full((), float(x), dtype=torch.float32, device=ref.device) for x in (a, b, c))
    a, b, c = torch.broadcast_tensors(a, b, c)
    if a.requires_grad or b.requires_grad or c.requires_grad:
        return _FMA.apply(a, b, c)
    return _fma_f64(a, b, c)


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a*b + c`` with a single rounding (broadcasting); each
    operand a tensor or a Python float, at least one a tensor. N1 on the
    card, the plain form on the CPU."""
    grad = torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in (a, b, c))
    if _on_cuda(a, b, c) and not grad:
        return _launch_fma(a, b, c)
    return fma_plain(a, b, c)


def sum_squares_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain form of :func:`sum_squares` on any device: ``x0*x0``, then
    one :func:`fma_plain` per further element (N1 each for an input on the
    card that requires grad)."""
    acc = x[..., 0] * x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = fma_plain(x[..., i], x[..., i], acc)
    return acc


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis as XLA-CPU's fused reduce forms
    it: ``x0*x0``, then one FMA per further element. N2 on the card; with
    an input that requires grad, the plain chain, whose FMAs are N1 there."""
    if x.device.type == "cuda" and not (x.requires_grad and torch.is_grad_enabled()):
        return _launch_sum_squares(x)
    return sum_squares_plain(x)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c``, correctly rounded on every device (see module docstring)."""
    return x / torch.full((), float(c), dtype=x.dtype, device=x.device)


class _Sqrt(torch.autograd.Function):
    """N3 forward (the plain root on a CPU tensor); the backward is the
    plain form's, ``g / (2 sqrt(x))`` in float64 rounded to float32."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return sqrt_plain(x) if x.device.type == "cpu" else _launch_sqrt(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (g.double() / (2 * torch.sqrt(x.double()))).float()


def sqrt_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain form of :func:`sqrt` on any device: the root in float64."""
    return torch.sqrt(x.double()).float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (see module docstring): N3 on
    the card, the plain form on the CPU."""
    return sqrt_plain(x) if x.device.type == "cpu" else _Sqrt.apply(x)


def time_obs(t: torch.Tensor, limit: int) -> torch.Tensor:
    """The time observation ``2 t / limit - 1`` of integer steps ``t``, as
    XLA compiles it in the reference's step: ``fma(2 t, float32(1 / limit),
    -1)``."""
    inv = float(np.float32(1.0) / np.float32(limit))
    t2 = 2.0 * t.to(torch.float32)
    return fma(t2, torch.full_like(t2, inv), -1.0)


@contextlib.contextmanager
def matmul_tf32(enabled: bool):
    """float32 products and convolutions on the card in TF32 (``enabled``)
    or in full float32, whatever the global settings (cuBLAS's
    ``torch.backends.cuda.matmul.allow_tf32`` and cuDNN's
    ``torch.backends.cudnn.allow_tf32``, which PyTorch turns on by default),
    which are restored after. The CPU's float32 products ignore them."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = prev
