"""The normalized cross-entropy's share of its roofline: its least time
per vector step (``yardstick.loss.cross_entropy_least_s``: the logits, the
labels and the base rewards read once, the losses and the rewards written
once) over the device time per step of the program's ``apx.vector.loss``
span. It divides fixed work by the span's time, so it reads the same work
whatever computes the loss. Nothing is read where the cell has no
cross-entropy loss or the span's time is not read."""

from benchmark.yardstick import loss


def read(ctx: dict) -> float | None:
    least = ctx["least_s"].get("cross_entropy")
    span_us = loss.per_step(ctx)
    if least is None or not span_us:
        return None
    return 100.0 * least / (span_us * 1e-6)
