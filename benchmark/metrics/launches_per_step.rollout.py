"""Device activities (kernels, memcpys, memsets) per vector step of a
rollout, over a profiled stretch of chunks: the graph's launches and the
copies of each chunk's draws into its buffers."""

from benchmark.yardstick import trace


def read(ctx: dict) -> float:
    return len(trace.device_events(ctx["trace"])) / ctx["steps"]
