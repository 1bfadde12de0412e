"""Optional NaN guards for action/prediction inputs (counterpart of
apx.core.checks).

The reference raises ValueError on NaN actions or predictions inside step.
apx cannot branch on data inside jit and wraps the step with checkify
instead; here the step is plain Python, so ``checked_step`` checks before
it steps. The check costs one ``isnan().any()`` per leaf and one host read
of all the flags together, which waits for the device: it is opt-in, as
in apx, and cannot run inside a CUDA graph capture.
"""

from __future__ import annotations

from typing import Callable

import torch

from .env import tree_map

__all__ = ["check_finite_action", "checked_step"]

_NAMES = ("action", "prediction")


def check_finite_action(full_action) -> None:
    """Raise ``ValueError("NaN values detected in action.")`` (or ``... in
    prediction.``) when a leaf of ``full_action["action"]`` (or of its
    ``"prediction"``) holds a NaN."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("check_finite_action reads the device and cannot run under "
                           "a CUDA graph capture")
    flags, owners = [], []
    for name in _NAMES:
        leaves: list[torch.Tensor] = []
        tree_map(leaves.append, full_action.get(name, ()))
        for leaf in leaves:
            flags.append(torch.isnan(leaf).any())
            owners.append(name)
    if not flags:
        return
    dev = flags[0].device
    found = torch.stack([f.to(dev) for f in flags]).tolist()  # the one host read
    for name in _NAMES:
        if any(f for f, o in zip(found, owners) if o == name):
            raise ValueError(f"NaN values detected in {name}.")


def checked_step(step_fn: Callable) -> Callable:
    """Wrap a ``step(state, full_action, params, ...)`` callable (an env's or
    a vector env's step) so NaN actions or predictions raise apx's
    ValueError before the step runs; finite inputs step unchanged."""

    def wrapper(state, full_action, *args, **kwargs):
        check_finite_action(full_action)
        return step_fn(state, full_action, *args, **kwargs)

    return wrapper
