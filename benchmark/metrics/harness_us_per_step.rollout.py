"""Device microseconds per vector step that the program's ``apx.vector.*``
and ``apx.env.*`` spans did not issue: the benchmark's own graph nodes
(the policy's probe and clamp, the per-env accumulators, the copies into
the graph's outputs) and the device events outside graph launches (the
copies of each chunk's draws; ``yardstick.stages``). Nothing is read from
a program without the spans, or where the trace disagrees with the
capture's layout."""

from benchmark.yardstick import stages


def read(ctx: dict) -> float | None:
    return stages.per_step(ctx, "harness")
