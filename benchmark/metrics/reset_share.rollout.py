"""The share of the envs asked of the LIDAR reset kernel (R) that it
computed, over its launches given a mask: computed over asked, from the
program's device counter ``fused_reset`` (``apx_torch.core.trace``
``counters``), summed over every such launch of the run (the warm replays,
the window and the traced chunks). Under NEXT_STEP each step asks R for
all N envs and R computes those that were done at the step before. Nothing
is read from a program without the counter, or where no launch was
masked."""


def read(ctx: dict) -> float | None:
    try:
        from apx_torch.core.trace import counters
    except ImportError:  # a program without device counters
        return None
    asked, computed = counters().get("fused_reset", (0, 0))
    return computed / asked if asked else None
