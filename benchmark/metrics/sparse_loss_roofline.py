"""The sparse loss's share of its roofline: its least time per vector step
(``yardstick.sparse.sparse_loss_least_s``: the logits, the labels, the
weights and the base rewards read once, the weighted losses, the rewards
and the dense losses written once) over the device time per step of the
program's ``apx.vector.loss`` and ``apx.vector.info_loss`` spans. It
divides fixed work by the spans' time, so it reads the same work whatever
computes the two losses. Nothing is read where the cell has no sparse loss
or the spans' time is not read."""

from benchmark.yardstick import sparse


def read(ctx: dict) -> float | None:
    least = ctx["least_s"].get("sparse_loss")
    span_us = sparse.sparse_loss_per_step(ctx)
    if least is None or not span_us:
        return None
    return 100.0 * least / (span_us * 1e-6)
