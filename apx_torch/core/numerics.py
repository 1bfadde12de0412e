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
root in float64, which rounds back to the correctly rounded float32 root
on every device.

Division by a Python scalar is another trap: PyTorch's CUDA ``div`` turns
``x / c`` into ``x * (1/c)`` when ``c`` is a host scalar, which is not the
correctly rounded quotient the CPU (and XLA) computes. :func:`div` divides
by a device tensor instead.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["fma", "sum_squares", "div", "sqrt", "time_obs", "matmul_tf32"]


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


class _FMA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        return _fma_f64(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return g * b, g * a, g


def fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """float32 ``a*b + c`` with a single rounding (broadcasting)."""
    if not isinstance(c, torch.Tensor):
        c = torch.full((), float(c), dtype=torch.float32, device=a.device)
    a, b, c = torch.broadcast_tensors(a, b, c)
    if a.requires_grad or b.requires_grad or c.requires_grad:
        return _FMA.apply(a, b, c)
    return _fma_f64(a, b, c)


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis as XLA-CPU's fused reduce forms
    it: ``x0*x0``, then one FMA per further element."""
    acc = x[..., 0] * x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = fma(x[..., i], x[..., i], acc)
    return acc


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c``, correctly rounded on every device (see module docstring)."""
    return x / torch.full((), float(c), dtype=x.dtype, device=x.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (see module docstring)."""
    return torch.sqrt(x.double()).float()


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
