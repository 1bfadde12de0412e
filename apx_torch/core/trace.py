"""The port's one span facility: named spans at its layer boundaries.

    with span("vector.step"):          # or @span("vector.step") on a function
        ...

A span's full name is ``"apx." + name``. It is inert unless one of three
things holds, and then it does what each asks:

* a ``torch.profiler`` is active: the span opens
  ``torch.autograd.profiler.record_function("apx." + name)``, so the trace
  carries a ``user_annotation`` event on the host and a
  ``gpu_user_annotation`` event on the device's clock over the kernels it
  issued (``python -m apx_torch.tools.parse_trace --spans`` tables them);
* the current CUDA stream is being captured into a graph: the span records
  into this process's registry, one layout per capture, its path (the
  full names of the open spans, outermost first) and the range of device
  nodes (kernel, memcpy, memset) the graph gained inside it, ``[first,
  last)``. The graph's own count gives the range (``csrc/capture.cu``,
  through the kernel library), and the layout's ``nodes`` is the graph's
  total when its capture ends. A replay runs no Python, so this layout is
  how a trace of replays is put down to the spans: replayed event k is
  node k (``owners``; ``benchmark/yardstick/stages.py`` reads it);
* a ``timed()`` block is open: host seconds per span path.

Beside the spans, kernel R's device counter (``reset_counter``): two
int64 values on the card that R's masked launches add to as they run, so
that the count is taken where the work happens, replays of a graph
included. ``counters()`` reads it.

Otherwise a span costs three tests of Python values: an open
``timed()``, the profiler's flag (``_is_profiler_enabled`` of
``torch.autograd.profiler``) and the count of captures in progress. The
registry keeps Python data only: ``layouts()`` returns copies, newest
last, and ``clear()`` empties it (and zeroes R's counter).

torch has no callback at the start or end of a capture, its capture query
(``torch.cuda.is_current_stream_capturing``) costs about 2 us on the host
of an H100, and the graph it captured is destroyed once instantiated. So
on a CUDA build this module wraps ``torch.cuda.CUDAGraph.capture_begin``
and ``capture_end`` when it is imported: they count the captures in
progress, and the end reads the graph's device nodes into the layout of
the capture that is ending before torch's own runs. Only under an open
capture does a span ask CUDA whether its stream is the one capturing.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

__all__ = ["span", "call", "timed", "HostTimes", "layouts", "clear", "owners",
           "reset_counter", "counters"]

_PREFIX = "apx."


def _no_capture() -> bool:
    return False


# torch built without CUDA has no capture to ask about (and its query raises).
_capturing = torch.cuda.is_current_stream_capturing if torch.backends.cuda.is_built() \
    else _no_capture
_OPEN = 0  # captures begun through torch.cuda.CUDAGraph and not yet ended


def _count_nodes() -> tuple[int, int]:
    """(capture id, device nodes of its graph so far) of the current
    stream's capture."""
    from ..ops import build

    cid, nodes = ctypes.c_ulonglong(), ctypes.c_longlong()
    err = build.load().apx_capture_nodes(torch.cuda.current_stream().cuda_stream,
                                         ctypes.byref(cid), ctypes.byref(nodes))
    if err != 0:
        raise RuntimeError(f"counting the captured graph's nodes failed: CUDA error {err}")
    return cid.value, nodes.value


_LAYOUTS: list[dict] = []  # in order of capture
_BY_CAPTURE: dict[int, dict] = {}
_RESET_COUNTS: dict[torch.device, torch.Tensor] = {}  # R's (asked, computed) by device
_TIMERS: list["HostTimes"] = []
_LOCAL = threading.local()


def _stack() -> list[str]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class span:
    """A span named ``"apx." + name``: a context manager, or a decorator
    that runs the function inside it."""

    __slots__ = ("name", "_open")

    def __init__(self, name: str):
        self.name = name
        self._open = None

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            return call(name, fn, *args, **kwargs)

        return spanned

    def __enter__(self):
        if _TIMERS or _profiler._is_profiler_enabled or _OPEN:
            self._open = _enter(_PREFIX + self.name)
        return self

    def __exit__(self, *exc) -> bool:
        if self._open is not None:
            _exit(self._open)
            self._open = None
        return False


def call(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` inside the span ``name``."""
    if not (_TIMERS or _profiler._is_profiler_enabled or _OPEN):
        return fn(*args, **kwargs)
    opened = _enter(_PREFIX + name)
    try:
        return fn(*args, **kwargs)
    finally:
        _exit(opened)


def _enter(full: str) -> tuple:
    stack = _stack()
    stack.append(full)
    path = tuple(stack)
    annotation = None
    if _profiler._is_profiler_enabled:
        annotation = _profiler.record_function(full)
        annotation.__enter__()
    first = _count_nodes() if _OPEN and _capturing() else None
    return path, annotation, first, time.perf_counter() if _TIMERS else None


def _exit(opened: tuple) -> None:
    path, annotation, first, t0 = opened
    if t0 is not None:
        dt = time.perf_counter() - t0
        for timer in _TIMERS:
            timer.total[path] = timer.total.get(path, 0.0) + dt
    if first is not None and _OPEN and _capturing():
        cid, last = _count_nodes()
        if cid == first[0]:
            _layout(cid)["spans"].append((path, first[1], last))
    if annotation is not None:
        annotation.__exit__(None, None, None)
    _stack().pop()


def _layout(cid: int) -> dict:
    layout = _BY_CAPTURE.get(cid)
    if layout is None:
        layout = _BY_CAPTURE[cid] = {"capture": cid, "nodes": None, "spans": []}
        _LAYOUTS.append(layout)
    return layout


def _watch_captures(graph_cls) -> None:
    """Wrap ``graph_cls.capture_begin`` and ``capture_end`` (see the
    module's docstring)."""
    begin, end = graph_cls.capture_begin, graph_cls.capture_end

    @functools.wraps(begin)
    def capture_begin(self, *args, **kwargs):
        global _OPEN
        out = begin(self, *args, **kwargs)
        _OPEN += 1
        return out

    @functools.wraps(end)
    def capture_end(self, *args, **kwargs):
        global _OPEN
        try:
            if _capturing():
                cid, nodes = _count_nodes()
                if cid in _BY_CAPTURE:
                    _BY_CAPTURE[cid]["nodes"] = nodes
            return end(self, *args, **kwargs)
        finally:
            _OPEN = max(0, _OPEN - 1)

    graph_cls.capture_begin, graph_cls.capture_end = capture_begin, capture_end


if torch.backends.cuda.is_built():
    _watch_captures(torch.cuda.CUDAGraph)


def layouts() -> list[dict]:
    """Each capture's layout, newest last: ``{"capture": id, "nodes": the
    graph's device nodes at the end of its capture (None before),
    "spans": [(path, first, last), ...]}``, spans in the order they
    closed (a child before its parent)."""
    return [{**layout, "spans": list(layout["spans"])} for layout in _LAYOUTS]


def clear() -> None:
    """Forget every layout and zero R's counter (in place: a captured
    graph keeps adding to it)."""
    _LAYOUTS.clear()
    _BY_CAPTURE.clear()
    for values in _RESET_COUNTS.values():
        values.zero_()


def reset_counter(device: torch.device) -> torch.Tensor | None:
    """Kernel R's counter on ``device``: two int64 values, zeros when
    made, to which R's launches given a mask add the envs asked and the
    envs computed. It lives as long as the process, at one address, so a
    graph that captured a launch adding to it keeps counting. It is made
    outside a capture only (a graph would hold its fill and zero it at
    every replay): None while it does not exist yet and the current stream
    is capturing, and that launch counts nothing."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    values = _RESET_COUNTS.get(device)
    if values is None:
        if _OPEN and _capturing():
            return None
        values = _RESET_COUNTS[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return values


def counters() -> dict[str, list[int]]:
    """``{"fused_reset": [asked, computed]}``, R's counter summed over its
    devices as Python ints (a read that waits for the device); empty
    before R's first launch given a mask."""
    values = [v.tolist() for v in _RESET_COUNTS.values()]
    return {"fused_reset": [sum(v[i] for v in values) for i in range(2)]} if values else {}


def owners(layout: dict, nodes: int | None = None) -> list[tuple[str, ...] | None]:
    """The path of the innermost span that issued each of the layout's
    device nodes (of ``nodes``, default the layout's total), None where no
    span did: a span's own nodes are those no child of it issued."""
    total = layout["nodes"] if nodes is None else nodes
    out: list[tuple[str, ...] | None] = [None] * total
    for path, first, last in sorted(layout["spans"], key=lambda s: len(s[0])):
        out[first:min(last, total)] = [path] * max(0, min(last, total) - first)
    return out


class HostTimes:
    """Host seconds per span path inside a ``timed()`` block: ``total`` maps
    each path to the seconds spent inside it."""

    def __init__(self):
        self.total: dict[tuple[str, ...], float] = {}

    def seconds(self, name: str) -> float:
        """Seconds inside the spans named ``name`` (without the prefix),
        wherever they nested."""
        return sum(s for path, s in self.total.items() if path[-1] == _PREFIX + name)


@contextlib.contextmanager
def timed():
    """Time every span entered in the block on the host's clock: yields
    the ``HostTimes``."""
    times = HostTimes()
    _TIMERS.append(times)
    try:
        yield times
    finally:
        _TIMERS.remove(times)
