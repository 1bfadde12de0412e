"""P, the loss and the reward of the vector env's op-by-op sites as one
hand-written CUDA launch (``apx_torch/csrc/loss.cu``).

``core/env.py`` computes a step's loss and reward with ``loss_and_reward``
wherever F2 does not: the DISABLED and LOCKSTEP steps and
``boundary_reset_step``, inside the span ``vector.loss``. It chooses by
what it is given (``kernel_terms``, a type and shape test):

* on CPU tensors, ``plain``: ``loss_fn(prediction, target)``, then
  ``loss_fn.reward(base_reward, loss, prediction, target)``, the chain the
  CPU tests hold to apx bitwise;
* on CUDA tensors, P where the loss is one it computes:

  - ``CrossEntropyLossFn``, alone or under an ``AffineLossFn`` (the
    classification ids' normalized loss), over (N, C) float32 logits with
    1 <= C <= 1024 and an (N,) int64 label:
    ``apx_loss_cross_entropy``, which reduces each row in the order of
    PyTorch's ``log_softmax`` and rounds every step of the chain as it
    does, so it equals the chain bitwise (a label outside [0, C) gives the
    chain's -0.0 loss);
  - a loss that ``core.losses.mse_terms`` describes, over (N, D) float32
    predictions and targets (the localization ids, LIDAR, LightDark):
    ``apx_loss_mse``, F2's arithmetic without its mask;

* on CUDA tensors with any other loss or shape (the ``-sparse`` ids'
  weighted loss, zero, a user's lambda, more than 1024 classes, a
  prediction of another rank or dtype), ``plain``.

Where P is chosen, a base reward that is not an (N,) float32 tensor on the
prediction's device raises, and so does a base reward or a target that
requires grad: the kernel's only gradient is the prediction's, through
``LossReward``, whose backward differentiates ``plain`` (as F2's does,
``ops.merge_cuda``). Operands are read in place when contiguous (a strided
one is copied first).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..core.losses import AffineLossFn, CrossEntropyLossFn, LossFn, MSETerms, mse_terms
from ._launch import entry

__all__ = ["CrossEntropyTerms", "kernel_terms", "plain", "loss_and_reward", "launch",
           "LossReward", "MAX_CLASSES", "MAX_N"]

KERNEL = "loss"
MAX_CLASSES = 1024  # loss.cu's kMaxClasses: PyTorch's warp softmax takes up to 1024
# The most rows a launch takes: the kernel's block count and thread index
# are ints.
MAX_N = 2**31 - 256


@dataclasses.dataclass(frozen=True)
class CrossEntropyTerms:
    """A cross-entropy loss over C classes as float32 constants: loss =
    -log_softmax(x)[label], then ``loss * scale + offset`` when
    ``affine``; reward = base - loss."""

    classes: int
    affine: bool
    scale: float
    offset: float


def _cross_entropy_terms(loss_fn: LossFn, classes: int) -> CrossEntropyTerms | None:
    affine = type(loss_fn) is AffineLossFn
    inner = loss_fn.inner if affine else loss_fn
    if type(inner) is not CrossEntropyLossFn or not 1 <= classes <= MAX_CLASSES:
        return None
    if not affine:
        return CrossEntropyTerms(classes, False, 1.0, 0.0)
    return CrossEntropyTerms(classes, True, float(np.float32(loss_fn.scale)),
                             float(np.float32(loss_fn.offset)))


def kernel_terms(loss_fn: LossFn, prediction, target) -> CrossEntropyTerms | MSETerms | None:
    """What P computes for this loss and these operands, or None where it
    computes nothing and ``plain`` runs; on any device (``loss_and_reward``
    asks only for CUDA tensors). A type and shape test."""
    if not (isinstance(prediction, torch.Tensor) and isinstance(target, torch.Tensor)
            and prediction.ndim == 2 and prediction.dtype == torch.float32
            and 0 < prediction.shape[0] <= MAX_N):
        return None
    n, width = prediction.shape
    if target.dtype == torch.int64 and tuple(target.shape) == (n,):
        return _cross_entropy_terms(loss_fn, width)
    if target.dtype == torch.float32 and target.shape == prediction.shape:
        return mse_terms(loss_fn, width)
    return None


def plain(loss_fn: LossFn, base_reward, prediction, target) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, reward) op by op: the chain P replaces, and its gradient."""
    loss = loss_fn(prediction, target)
    return loss, loss_fn.reward(base_reward, loss, prediction, target)


class LossReward(torch.autograd.Function):
    """(loss, reward) of a launch, differentiable in the prediction: the
    backward runs ``plain`` (a function of the prediction) again on the
    saved prediction and differentiates it, so the gradient is the plain
    path's bitwise. P's and F2's (``ops.merge_cuda``)."""

    @staticmethod
    def forward(ctx, prediction, launch, plain):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(prediction)
        ctx.plain = plain
        return launch()

    @staticmethod
    def backward(ctx, g_loss, g_reward):
        (prediction,) = ctx.saved_tensors
        with torch.enable_grad():
            p = prediction.detach().requires_grad_()
            outs = ctx.plain(p)
            used = [(o, g) for o, g in zip(outs, (g_loss, g_reward)) if g is not None]
            if not used:
                return None, None, None
            (grad,) = torch.autograd.grad([o for o, _ in used], p, [g for _, g in used],
                                          allow_unused=True)
        return grad, None, None


_ptr, _int, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_CROSS_ENTROPY = entry("P", "loss_cross_entropy_launch",
                       [*[_ptr] * 5, *[_int] * 3, _f32, _f32])
_MSE = entry("P", "loss_mse_launch", [*[_ptr] * 5, *[_int] * 5, *[_f32] * 3])


def loss_and_reward(loss_fn: LossFn, base_reward, prediction,
                    target) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, reward) of a step: P on CUDA tensors that ``kernel_terms``
    describes, else ``plain`` (see the module docstring)."""
    terms = None
    if isinstance(prediction, torch.Tensor) and prediction.device.type == "cuda":
        terms = kernel_terms(loss_fn, prediction, target)
    if terms is None:
        return plain(loss_fn, base_reward, prediction, target)
    return launch(terms, loss_fn, base_reward, prediction, target)


def launch(terms: CrossEntropyTerms | MSETerms, loss_fn: LossFn, base_reward, prediction,
           target) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, reward) by P for ``kernel_terms``' ``terms`` of these
    operands, or an error (see the module docstring)."""
    n, dev = prediction.shape[0], prediction.device
    if not (isinstance(base_reward, torch.Tensor) and base_reward.shape == (n,)
            and base_reward.dtype == torch.float32 and base_reward.device == dev
            and target.device == dev):
        got = (tuple(base_reward.shape), base_reward.dtype, str(base_reward.device)) \
            if isinstance(base_reward, torch.Tensor) else type(base_reward).__name__
        raise ValueError(f"{KERNEL}: base_reward must be ({n},) float32 and the target on "
                         f"{dev}, got {got} and a target on {target.device}")
    if torch.is_grad_enabled() and (base_reward.requires_grad or target.requires_grad):
        raise ValueError(f"{KERNEL}: the base reward or the prediction target requires grad; "
                         "the kernel differentiates the prediction only: detach the action")
    pred = prediction.detach().contiguous()
    base, tgt = base_reward.contiguous(), target.detach().contiguous()
    out = torch.empty((2, n), dtype=torch.float32, device=dev)

    def run():
        if isinstance(terms, CrossEntropyTerms):
            _CROSS_ENTROPY(dev, pred.data_ptr(), tgt.data_ptr(), base.data_ptr(),
                           out[0].data_ptr(), out[1].data_ptr(), n, terms.classes,
                           int(terms.affine), terms.scale, terms.offset)
        else:
            _MSE(dev, pred.data_ptr(), tgt.data_ptr(), base.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), n, terms.d, int(terms.fused_sum), int(terms.affine),
                 int(terms.contract), terms.scale, terms.offset, terms.k)
        return out[0], out[1]

    if torch.is_grad_enabled() and prediction.requires_grad:
        return LossReward.apply(prediction, run, lambda p: plain(loss_fn, base_reward, p, target))
    return run()
