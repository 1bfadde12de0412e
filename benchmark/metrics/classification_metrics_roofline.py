"""The classification metrics' share of their roofline: their least time
per vector step (``yardstick.sparse.classification_metrics_least_s``: the
logits, the labels, the buffers, the counts and the dones read once, the
buffers, the counts, the statistics and their masks written once) over
the device time per step of the program's ``apx.vector.metrics`` span.
Nothing is read where the cell has no classification metrics or the
span's time is not read."""

from benchmark.yardstick import sparse


def read(ctx: dict) -> float | None:
    least = ctx["least_s"].get("classification_metrics")
    span_us = sparse.metrics_per_step(ctx)
    if least is None or not span_us:
        return None
    return 100.0 * least / (span_us * 1e-6)
