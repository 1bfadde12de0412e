"""The LIDAR step function's share of its roofline: its least time per
vector step at the cell's shapes (``yardstick.bounds.lidar_step_least_s``:
the three casts and the arithmetic around them, the map at one bit a cell)
over the device time per step of the kernels that compute it. Nothing is
read where no kernel of these names ran."""

from benchmark.yardstick import trace

# The kernels that compute the LIDAR step on the dense path: kernel S.
PATTERNS = ("apx_lidar_fused_step",)


def read(ctx: dict) -> float | None:
    kernel_us = trace.matching_us(ctx["trace"], PATTERNS)
    least = ctx["least_s"].get("lidar_step")
    if kernel_us <= 0 or least is None:
        return None
    return 100.0 * least * ctx["steps"] / (kernel_us * 1e-6)
