"""Device-busy microseconds per vector step of a rollout: the union of the
device's activity intervals over a profiled stretch of chunks, over its
steps."""

from benchmark.yardstick import trace


def read(ctx: dict) -> float:
    return trace.busy_us(ctx["trace"]) / ctx["steps"]
