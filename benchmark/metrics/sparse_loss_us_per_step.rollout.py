"""Device microseconds per vector step of the graph nodes the program
issued under ``apx.vector.loss`` or ``apx.vector.info_loss``: a ``-sparse``
id's weighted loss and reward, and the dense loss it reports in the info
(``yardstick.sparse``). A part of ``vector_merge_us_per_step.rollout``.
Nothing is read from a program without ``apx.vector.loss``, or where the
trace disagrees with the capture's layout."""

from benchmark.yardstick import sparse


def read(ctx: dict) -> float | None:
    return sparse.sparse_loss_per_step(ctx)
