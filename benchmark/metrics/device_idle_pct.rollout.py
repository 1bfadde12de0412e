"""The device's idle share in a rollout: 1 less the union of the device's
activity intervals over a profiled stretch of chunks, over the wall time of
the same chunks replayed unprofiled (the port's bench arithmetic)."""

from benchmark.yardstick import trace


def read(ctx: dict) -> float:
    return 100.0 * (1.0 - trace.busy_us(ctx["trace"]) * 1e-6 / ctx["wall_s"])
