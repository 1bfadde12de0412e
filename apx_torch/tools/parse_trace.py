"""Summarize a torch.profiler trace into a per-op device-time table
(counterpart of apx.tools.parse_trace, which reads jax.profiler traces).

``torch.profiler``'s ``export_chrome_trace`` writes chrome-trace JSON (what
``python -m apx_torch.bench --profile --trace DIR`` writes). This tool
turns it into a table of time per op, the device's busy time and its
longest idle gaps.

Usage:
    python -m apx_torch.tools.parse_trace TRACE_JSON_OR_DIR [--top N] [--steps S]
    python -m apx_torch.tools.parse_trace trace.json --all-processes

Device-only is the default; ``--all-processes`` adds the host rows.
``--steps S`` divides every time and count by S (per-step figures).

How a torch trace marks the device (as torch 2.11 with CUDA 12.8 writes
it on an H100): CUPTI's activities are complete events ("ph": "X") with
``cat`` "kernel", "gpu_memcpy" or "gpu_memset", under a process per
device (pid = device index, ``process_labels`` "GPU <i>") and a thread
per stream (tid = stream id); kernels replayed from a CUDA graph appear
the same way. Host rows are everything else: "cpu_op", "python_function",
"cuda_runtime" / "cuda_driver" (the launch calls), "user_annotation",
"overhead" (the profiler's own buffer requests, pid -1) and one "Trace"
span over the whole window (pid "Spans"). There is no modules lane as in
an XLA trace, and kernels on two streams overlap, so the busy time is the
UNION of the device intervals, not their sum. A trace taken without CUDA
activity has no device rows; ``device_busy_us`` raises then, as apx's
does.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os

__all__ = ["DEVICE_CATEGORIES", "load_trace", "device_events", "summarize", "device_busy_us",
           "device_summed_us", "idle_gaps", "main"]

# ``cat`` of the device activities in a torch.profiler chrome trace.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def load_trace(path: str) -> dict:
    """path: a trace .json or .json.gz file OR a directory (the newest
    .json / .json.gz file in it, e.g. a tensorboard_trace_handler's
    ``*.pt.trace.json``)."""
    if os.path.isdir(path):
        cands = glob.glob(os.path.join(path, "*.json")) + glob.glob(
            os.path.join(path, "*.json.gz"))
        if not cands:
            raise FileNotFoundError(f"no .json or .json.gz trace under {path}")
        path = max(cands, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _process_names(events) -> dict:
    """pid -> the process's label ("GPU 0", "CPU") where the trace gives
    one, else its name."""
    names, labels = {}, {}
    for e in events:
        if e.get("ph") != "M":
            continue
        if e.get("name") == "process_name":
            names[e["pid"]] = e.get("args", {}).get("name", str(e["pid"]))
        elif e.get("name") == "process_labels":
            labels[e["pid"]] = e.get("args", {}).get("labels", "")
    return {pid: labels.get(pid) or names.get(pid, str(pid)) for pid in {**names, **labels}}


def _is_device(e) -> bool:
    return e.get("ph") == "X" and str(e.get("cat", "")).lower() in DEVICE_CATEGORIES


def device_events(trace: dict) -> list[dict]:
    """The device activities (kernels, memcpys, memsets), in trace order."""
    return [e for e in trace.get("traceEvents", []) if _is_device(e)]


def summarize(trace: dict, device_only: bool = True):
    """Returns [(process, op_name, total_us, count)] sorted by time desc."""
    events = trace.get("traceEvents", [])
    procs = _process_names(events)
    tot: collections.Counter = collections.Counter()
    cnt: collections.Counter = collections.Counter()
    for e in events:
        if e.get("ph") != "X":
            continue
        if device_only and not _is_device(e):
            continue
        key = (procs.get(e.get("pid"), str(e.get("pid"))), e.get("name", "?"))
        tot[key] += e.get("dur", 0)
        cnt[key] += 1
    return [(proc, name, us, cnt[(proc, name)]) for (proc, name), us in tot.most_common()]


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


def device_busy_us(trace: dict) -> float:
    """Microseconds in which at least one device activity ran: the union of
    their intervals, so two streams' overlapping kernels count once."""
    return float(sum(e - s for s, e in _intervals(trace)))


def device_summed_us(trace: dict) -> float:
    """The device activities' durations summed (overlaps counted twice):
    what ``torch.profiler``'s ``key_averages()`` adds up as device time."""
    return float(sum(e.get("dur", 0) for e in device_events(trace)))


def idle_gaps(trace: dict, top: int = 5) -> list[dict]:
    """The ``top`` longest gaps between device intervals (the device idle,
    inside the traced window), longest first; each with the host event
    that spans it: the shortest host complete event covering the whole gap
    (the profiler's whole-window "Trace" span and the annotations it draws
    on the device's timeline, "gpu_user_annotation", excepted), else the
    one overlapping it most. Each gap is ``{"start_us", "us", "host",
    "host_cat"}``."""
    spans = _intervals(trace)
    gaps = [(s2 - e1, e1, s2) for (_, e1), (s2, _) in zip(spans, spans[1:]) if s2 > e1]
    gaps.sort(key=lambda g: -g[0])
    host = [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and not _is_device(e) and "dur" in e
            and e.get("cat") != "Trace" and not str(e.get("cat", "")).startswith("gpu_")]
    out = []
    for us, start, end in gaps[:top]:
        best, best_key = None, None
        for e in host:
            s, d = float(e["ts"]), float(e["dur"])
            overlap = min(end, s + d) - max(start, s)
            if overlap <= 0:
                continue
            covers = s <= start and s + d >= end
            key = (0, d) if covers else (1, -overlap)
            if best_key is None or key < best_key:
                best, best_key = e, key
        out.append({"start_us": start, "us": us,
                    "host": None if best is None else best.get("name"),
                    "host_cat": None if best is None else best.get("cat")})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="trace .json(.gz) or a directory holding one")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--steps", type=int, default=1, help="divide times and counts by this")
    ap.add_argument(
        "--all-processes", action="store_true",
        help="include host rows (default: device ops only)",
    )
    args = ap.parse_args(argv)
    trace = load_trace(args.path)
    rows = summarize(trace, device_only=not args.all_processes)
    per = f" per step of {args.steps}" if args.steps != 1 else ""
    print(f"{'total ms':>10}  {'count':>9}  process / op{per}")
    for proc, name, us, n in rows[: args.top]:
        print(f"{us / 1e3 / args.steps:10.4f}  {n / args.steps:9.2f}  {proc}  {name[:90]}")
    if device_events(trace):
        print(f"device busy (union): {device_busy_us(trace) / 1e3 / args.steps:.4f} ms{per}; "
              f"summed: {device_summed_us(trace) / 1e3 / args.steps:.4f} ms; "
              f"activities: {len(device_events(trace)) / args.steps:.2f}")
        for g in idle_gaps(trace):
            print(f"idle gap {g['us']:.1f} us at {g['start_us']:.1f}: {g['host']} ({g['host_cat']})")
    else:
        print("no device rows in this trace")


if __name__ == "__main__":
    main()
