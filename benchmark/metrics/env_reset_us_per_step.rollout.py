"""Device microseconds per vector step of the graph nodes the program
issued under its ``apx.env.reset`` and ``apx.env.draw`` spans: the env's
reset from draws, the reset's prediction target and the draws the vector
env makes itself (``yardstick.stages``). Nothing is read from a program
without the spans, or where the trace disagrees with the capture's
layout."""

from benchmark.yardstick import stages


def read(ctx: dict) -> float | None:
    return stages.per_step(ctx, "env_reset")
