"""Device microseconds per vector step of the graph nodes the program
issued under its ``apx.vector.loss`` span: the loss and the reward where
the vector env computes them op by op (LOCKSTEP, DISABLED and the boundary
step; ``yardstick.loss``). A part of ``vector_merge_us_per_step.rollout``.
Nothing is read from a program without the span, or where the trace
disagrees with the capture's layout."""

from benchmark.yardstick import loss


def read(ctx: dict) -> float | None:
    return loss.per_step(ctx)
