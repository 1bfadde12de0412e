"""Device microseconds per vector step of the graph nodes the program
issued under its ``apx.vector.*`` spans outside their ``apx.env.*``
children: the vector env's merge (NEXT_STEP's F2 call, LOCKSTEP's
selects, the loss, the reward, the derived obs, the info;
``yardstick.stages``). Nothing is read from a program without the spans,
or where the trace disagrees with the capture's layout."""

from benchmark.yardstick import stages


def read(ctx: dict) -> float | None:
    return stages.per_step(ctx, "vector_merge")
