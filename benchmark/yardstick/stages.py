"""The device time of a rollout's traced chunks split by the program's
stages, read through the capture layout of the chunk's CUDA graph.

A replay runs no Python, so the program's spans (``apx_torch.core.trace``)
cannot time one. They record at capture instead: each span's path (the
spans open around it, outermost first) and the range ``[first, last)`` of
the graph's device nodes issued inside it, and the graph's device nodes in
all. In a trace of replays, the device events of one replay are those
whose ``correlation`` is that of a graph launch on the host; ordered by
``graph node id`` where every one has it, else by start time, event k is
node k, and it belongs to the innermost span whose range holds k.

The stages, which partition the traced device time:

* ``env_step``: under an ``apx.env.step`` span (the env's own step);
* ``env_reset``: under ``apx.env.reset`` or ``apx.env.draw`` (the reset
  from draws, the reset's target, draws the vector env makes);
* ``vector_merge``: under an ``apx.vector.*`` span and no ``apx.env.*``
  one (the merge: selects, loss, reward, derived obs, info);
* ``harness``: under none of these (the benchmark's policy, accumulators
  and copies into the graph's outputs), and every device event outside a
  graph launch (the copies of each chunk's draws into its buffers).

``split`` reads nothing (None) where the program recorded no layout (one
without the spans), and where the trace disagrees with the newest layout:
a replay with another number of events than the layout's nodes, replays
that differ from one another, or a node under an ``apx.kernel.<id>`` span
whose event does not carry that kernel's symbol
(``apx_torch.ops._launch.KERNELS``).
"""

from __future__ import annotations

import collections

from . import trace as tr

__all__ = ["STAGES", "stage_of", "replays", "split_us", "per_step"]

STAGES = ("env_step", "env_reset", "vector_merge", "harness")
KERNEL_SPAN = "apx.kernel."


def stage_of(path: tuple[str, ...] | None) -> str:
    """The stage of a node issued under the spans ``path`` (None: none)."""
    names = set(path or ())
    if "apx.env.step" in names:
        return "env_step"
    if names & {"apx.env.reset", "apx.env.draw"}:
        return "env_reset"
    if any(n.startswith("apx.vector.") for n in names):
        return "vector_merge"
    return "harness"


def _is_graph_launch(e: dict) -> bool:
    return e.get("ph") == "X" and str(e.get("name", "")).startswith(
        ("cudaGraphLaunch", "cuGraphLaunch"))


def replays(trace: dict) -> tuple[list[list[dict]], list[dict]]:
    """(each graph launch's device events in node order, launches in the
    order they ran; the device events of no graph launch)."""
    launches = {e.get("args", {}).get("correlation")
                for e in trace.get("traceEvents", []) if _is_graph_launch(e)}
    launches.discard(None)
    by_launch: dict = collections.defaultdict(list)
    outside = []
    for e in tr.device_events(trace):
        corr = e.get("args", {}).get("correlation")
        if corr in launches:
            by_launch[corr].append(e)
        else:
            outside.append(e)
    runs = []
    for events in by_launch.values():
        if all("graph node id" in e.get("args", {}) for e in events):
            events.sort(key=lambda e: int(e["args"]["graph node id"]))
        else:
            events.sort(key=lambda e: float(e["ts"]))
        runs.append(events)
    runs.sort(key=lambda run: float(run[0]["ts"]))
    return runs, outside


def split_us(trace: dict, layout: dict, owners, kernels: dict) -> dict | None:
    """Device microseconds of the trace by stage, through ``layout`` (a
    capture layout of ``apx_torch.core.trace``; ``owners`` its node-owner
    function, ``kernels`` the kernels' symbols by id); None where the
    trace disagrees with the layout."""
    runs, outside = replays(trace)
    total = layout.get("nodes")
    if not runs or total is None:
        return None
    names = [str(e.get("name", "")) for e in runs[0]]
    if any(len(run) != total or [str(e.get("name", "")) for e in run] != names
           for run in runs):
        return None
    own = owners(layout)
    for name, path in zip(names, own):
        if path and path[-1].startswith(KERNEL_SPAN):
            symbol = kernels.get(path[-1][len(KERNEL_SPAN):])
            if symbol is None or symbol not in name:
                return None
    out = dict.fromkeys(STAGES, 0.0)
    for run in runs:
        for e, path in zip(run, own):
            out[stage_of(path)] += float(e.get("dur", 0))
    out["harness"] += sum(float(e.get("dur", 0)) for e in outside)
    return out


def per_step(ctx: dict, stage: str) -> float | None:
    """Device microseconds per vector step of ``stage`` in a traced run's
    context, or None (see the module's docstring)."""
    try:
        from apx_torch.core import trace as spans
        from apx_torch.ops._launch import KERNELS
    except ImportError:  # a program without the span facility
        return None
    layouts = spans.layouts()
    if not layouts:
        return None
    got = split_us(ctx["trace"], layouts[-1], spans.owners, KERNELS)
    return None if got is None else got[stage] / ctx["steps"]
