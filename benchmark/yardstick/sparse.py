"""The ``-sparse`` ids' two losses and the classification log wrapper: the
device time of the graph nodes the program issued under their spans, read
through the capture layout as ``loss.py`` reads one span, and the least
time of each at the cell's shapes.

* The sparse loss: the nodes whose span path holds ``apx.vector.loss``
  (the weighted loss and the reward) or ``apx.vector.info_loss`` (the
  dense loss that ``Sparsify`` reports in the info). The union reads the
  same work if a later program computes both in one launch under either
  span. It reads nothing (None) where the layout has no
  ``apx.vector.loss`` span, or where ``stages.split_us`` reads nothing.
* The classification metrics: the nodes under ``apx.vector.metrics`` (the
  wrapper's bookkeeping after the inner step), None where the layout has
  no such span (``loss.per_step``).

Both lie inside the ``vector_merge`` stage. The bytes are each function's
contract (``bounds.py``'s rule): every input read once and every output
written once, whatever the launches in between read and write again.
"""

from __future__ import annotations

from . import loss, stages
from .peaks import HBM_BYTES_PER_S

__all__ = ["LOSS_SPANS", "METRICS_SPAN", "union_us", "sparse_loss_per_step",
           "metrics_per_step", "sparse_loss_bytes", "sparse_loss_least_s",
           "classification_metrics_terms", "classification_metrics_bytes",
           "classification_metrics_least_s"]

LOSS_SPANS = (loss.SPAN, "apx.vector.info_loss")
METRICS_SPAN = "apx.vector.metrics"


def union_us(trace: dict, layout: dict, owners, kernels: dict,
             names: tuple[str, ...] = LOSS_SPANS) -> float | None:
    """Device microseconds, over every replay of the trace, of the nodes
    whose span path holds any of ``names``; None where the layout has no
    span named ``names[0]`` or ``stages.split_us`` reads nothing."""
    if not any(names[0] in path for path, _, _ in layout.get("spans", ())):
        return None
    if stages.split_us(trace, layout, owners, kernels) is None:
        return None
    runs, _ = stages.replays(trace)
    own = owners(layout)
    return sum(float(e.get("dur", 0)) for run in runs for e, path in zip(run, own)
               if path and any(name in path for name in names))


def sparse_loss_per_step(ctx: dict) -> float | None:
    """Device microseconds per vector step of the sparse loss's nodes in a
    traced run's context, or None (see the module's docstring)."""
    try:
        from apx_torch.core import trace as spans
        from apx_torch.ops._launch import KERNELS
    except ImportError:  # a program without the span facility
        return None
    layouts = spans.layouts()
    if not layouts:
        return None
    got = union_us(ctx["trace"], layouts[-1], spans.owners, KERNELS)
    return None if got is None else got / ctx["steps"]


def metrics_per_step(ctx: dict) -> float | None:
    """Device microseconds per vector step of the nodes under
    ``apx.vector.metrics``, or None (see the module's docstring)."""
    return loss.per_step(ctx, METRICS_SPAN)


def sparse_loss_bytes(n: int, classes: int) -> int:
    """Bytes of one vector step's sparse loss over n envs: reads the (n,
    classes) float32 logits, the int64 labels, the float32 weights and
    base rewards once; writes the weighted losses and the rewards (what
    the vector env's loss site returns) and the dense losses (the info's)
    once, all float32."""
    return n * (4 * classes + 8 + 4 + 4 + 4 + 4 + 4)


def sparse_loss_least_s(n: int, classes: int) -> float:
    """Least seconds of one vector step's sparse loss: its bytes at the HBM
    rate (its few operations an element are far below the float32 rate)."""
    return sparse_loss_bytes(n, classes) / HBM_BYTES_PER_S


def classification_metrics_terms(classes: int, buffer_len: int) -> dict[str, int]:
    """Bytes an env of one vector step's classification metrics, by term.

    Read once: the float32 logits (``logits``), the int64 label (``label``),
    the (buffer_len,) float32 buffer and the int32 count (``buffer_read``,
    ``count_read``), the step's terminated and truncated flags and the
    previous done (``dones``, a byte each). Written once: the buffer and
    the count (``buffer_write``, ``count_write``), the new previous done
    (``done_write``), the four float32 statistics (``avg_`` and
    ``final_correct_label_prob``, ``avg_`` and ``final_accuracy``) and the
    two int32 step indices (``first_correct``, ``last_incorrect``) as
    ``statistics``, and the boolean masks the wrapper returns (``masks``:
    the six statistics' ``_<name>``, ``_scalar``, ``_vector`` and the
    buffer's ``_correct_label_prob``). The wrapper's ``vector`` and
    ``vector_lengths`` are the buffer and the count, written once."""
    return {"logits": 4 * classes, "label": 8, "buffer_read": 4 * buffer_len, "count_read": 4,
            "dones": 3, "buffer_write": 4 * buffer_len, "count_write": 4, "done_write": 1,
            "statistics": 4 * 4 + 2 * 4, "masks": 6 + 3}


def classification_metrics_bytes(n: int, classes: int, buffer_len: int) -> int:
    """Bytes of one vector step's classification metrics over n envs."""
    return n * sum(classification_metrics_terms(classes, buffer_len).values())


def classification_metrics_least_s(n: int, classes: int, buffer_len: int) -> float:
    """Least seconds of one vector step's classification metrics: their
    bytes at the HBM rate (a softmax over the logits and a few operations
    an entry of the buffer, far below the float32 rate)."""
    return classification_metrics_bytes(n, classes, buffer_len) / HBM_BYTES_PER_S
