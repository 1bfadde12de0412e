"""The glimpses' share of their roofline: their least time per vector step
(``yardstick.bounds.glimpse_least_s`` over each glimpse launch of an
episode: the pixels the hats touch, the positions and the output) over the
device time per step of the kernel that computes them, K3. Nothing is read
where no kernel of this name ran."""

from benchmark.yardstick import trace

PATTERNS = ("glimpse_kernel",)


def read(ctx: dict) -> float | None:
    kernel_us = trace.matching_us(ctx["trace"], PATTERNS)
    least = ctx["least_s"].get("glimpse")
    if kernel_us <= 0 or least is None:
        return None
    return 100.0 * least * ctx["steps"] / (kernel_us * 1e-6)
