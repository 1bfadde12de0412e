"""The vector env's loss: the device time of the graph nodes the program
issued under its ``apx.vector.loss`` span, read through the capture layout
as ``stages.py`` reads the stages, and the least time of the normalized
cross-entropy loss and its reward at the cell's shapes.

The span's nodes lie inside the ``vector_merge`` stage (an ``apx.vector.*``
span with no ``apx.env.*`` one around it), so this reads a part of that
stage and changes none of the four. It reads nothing (None) where
``stages.split_us`` does (no layout, or a trace that disagrees with the
newest one), and where the layout holds no such span: a program without
it, or one whose loss is inside another kernel (F2 under NEXT_STEP).

The bytes are the function's contract (``bounds.py``'s rule): the logits
read once, the label (int64), the base reward read, the loss and the
reward written, all float32 but the label. They do not depend on how many
launches compute it, so no implementation can read above its bound.
"""

from __future__ import annotations

from . import stages
from .peaks import HBM_BYTES_PER_S

__all__ = ["SPAN", "span_us", "per_step", "cross_entropy_bytes", "cross_entropy_least_s"]

SPAN = "apx.vector.loss"


def span_us(trace: dict, layout: dict, owners, kernels: dict, name: str = SPAN) -> float | None:
    """Device microseconds, over every replay of the trace, of the nodes
    whose span path holds ``name``; None where ``stages.split_us`` reads
    nothing or the layout has no span of that name."""
    if not any(name in path for path, _, _ in layout.get("spans", ())):
        return None
    if stages.split_us(trace, layout, owners, kernels) is None:
        return None
    runs, _ = stages.replays(trace)
    own = owners(layout)
    return sum(float(e.get("dur", 0)) for run in runs for e, path in zip(run, own)
               if path and name in path)


def per_step(ctx: dict, name: str = SPAN) -> float | None:
    """Device microseconds per vector step of the nodes under ``name`` in a
    traced run's context, or None (see the module's docstring)."""
    try:
        from apx_torch.core import trace as spans
        from apx_torch.ops._launch import KERNELS
    except ImportError:  # a program without the span facility
        return None
    layouts = spans.layouts()
    if not layouts:
        return None
    got = span_us(ctx["trace"], layouts[-1], spans.owners, KERNELS, name)
    return None if got is None else got / ctx["steps"]


def cross_entropy_bytes(n: int, classes: int) -> int:
    """Bytes of one vector step's normalized cross-entropy and reward over
    n envs: reads the (n, classes) float32 logits, the int64 labels and the
    base rewards; writes the losses and the rewards."""
    return n * (4 * classes + 8 + 4 + 4 + 4)


def cross_entropy_least_s(n: int, classes: int) -> float:
    """Least seconds of one vector step's cross-entropy and reward: its
    bytes at the HBM rate (its few operations an element are far below the
    float32 rate)."""
    return cross_entropy_bytes(n, classes) / HBM_BYTES_PER_S
