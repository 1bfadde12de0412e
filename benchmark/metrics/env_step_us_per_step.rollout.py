"""Device microseconds per vector step of the graph nodes the program
issued under its ``apx.env.step`` spans: the env's own step
(``yardstick.stages``). Nothing is read from a program without the spans,
or where the trace disagrees with the capture's layout."""

from benchmark.yardstick import stages


def read(ctx: dict) -> float | None:
    return stages.per_step(ctx, "env_step")
