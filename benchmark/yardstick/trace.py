"""The trace arithmetic of the benchmark: a frozen copy of the port's
``tools/parse_trace.py`` (the union of device intervals, the idle gaps and
the time per device operation), read from a ``torch.profiler`` chrome
trace.

CUPTI's activities are complete events (``"ph": "X"``) with ``cat``
"kernel", "gpu_memcpy" or "gpu_memset"; kernels replayed from a CUDA graph
appear the same way. Everything else is the host. Kernels on two streams
overlap, so the busy time is the union of the device intervals, not their
sum.
"""

from __future__ import annotations

import collections
import json

__all__ = ["DEVICE_CATEGORIES", "load", "device_events", "busy_us", "idle_gaps", "top_ops",
           "matching_us"]

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _is_device(e: dict) -> bool:
    return e.get("ph") == "X" and str(e.get("cat", "")).lower() in DEVICE_CATEGORIES


def device_events(trace: dict) -> list[dict]:
    """The device activities (kernels, memcpys, memsets), in trace order."""
    return [e for e in trace.get("traceEvents", []) if _is_device(e)]


def _intervals(trace: dict) -> list[tuple[float, float]]:
    """The device activities' [start, end) in microseconds, merged where
    they overlap or touch, sorted."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in device_events(trace))
    if not spans:
        raise ValueError("no device events in trace (kernel, gpu_memcpy or gpu_memset)")
    merged = [list(spans[0])]
    for start, end in spans[1:]:
        if start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]


def busy_us(trace: dict) -> float:
    """Microseconds in which at least one device activity ran."""
    return float(sum(e - s for s, e in _intervals(trace)))


def idle_gaps(trace: dict, top: int = 10) -> list[tuple[str, float]]:
    """The ``top`` longest gaps between device intervals, longest first,
    as (what the host was doing, microseconds): the shortest host event
    covering the whole gap (the profiler's own spans over the window and
    each of its steps, and their device-side annotations, excepted), else
    the one overlapping it most."""
    spans = _intervals(trace)
    gaps = sorted(((s2 - e1, e1, s2) for (_, e1), (s2, _) in zip(spans, spans[1:]) if s2 > e1),
                  reverse=True)
    host = [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and not _is_device(e) and "dur" in e
            and e.get("cat") != "Trace" and not str(e.get("cat", "")).startswith("gpu_")
            and not str(e.get("name", "")).startswith("ProfilerStep#")]
    out = []
    for us, start, end in gaps[:top]:
        best, best_key = None, None
        for e in host:
            s, d = float(e["ts"]), float(e["dur"])
            overlap = min(end, s + d) - max(start, s)
            if overlap <= 0:
                continue
            key = (0, d) if s <= start and s + d >= end else (1, -overlap)
            if best_key is None or key < best_key:
                best, best_key = e, key
        out.append(("(no host event)" if best is None else str(best.get("name")), us))
    return out


def top_ops(trace: dict, top: int = 10) -> list[tuple[str, float]]:
    """The device operations that took most time, summed by name:
    (name, microseconds), most first."""
    tot: collections.Counter = collections.Counter()
    for e in device_events(trace):
        tot[str(e.get("name", "?"))] += float(e.get("dur", 0))
    return tot.most_common(top)


def matching_us(trace: dict, patterns: tuple[str, ...]) -> float:
    """Summed microseconds of the device activities whose name contains
    one of ``patterns``."""
    return float(sum(float(e.get("dur", 0)) for e in device_events(trace)
                     if any(p in str(e.get("name", "")) for p in patterns)))
