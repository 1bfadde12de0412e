"""Device microseconds per vector step of the graph nodes the program
issued under its ``apx.vector.metrics`` span: the episode-metric wrapper's
bookkeeping after the inner step (the step's metrics, the buffers, the
aggregates; ``yardstick.sparse``). A part of
``vector_merge_us_per_step.rollout``. Nothing is read from a program
without the span, or where the trace disagrees with the capture's
layout."""

from benchmark.yardstick import sparse


def read(ctx: dict) -> float | None:
    return sparse.metrics_per_step(ctx)
