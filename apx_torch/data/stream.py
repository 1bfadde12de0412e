"""Host-side streaming: iterators, prefetch, and device bank rotation
(counterpart of apx.data.stream).

Behavioural reference: ap_gym's ``envs/dataset`` package:

* ``DatasetIterator`` / ``DatasetBatchIterator``: infinite i.i.d. index
  sampling with replacement (numpy draws, bitwise apx's for a seed);
* ``BufferedIterator``: a daemon thread filling a bounded queue,
  exceptions forwarded, weakref-finalized shutdown;
* ``DataLoader``: an optional prefetch wrapper.

The per-step path never touches the host (banks live on the device), so
these serve ingestion pipelines and ``BankRotator``: corpora larger than
device memory are split into sub-banks, a thread stages the next sub-bank
(host numpy -> pinned memory -> device, on a side CUDA stream) while the
envs sample the current one, and ``swap()`` exchanges them between
episodes.
"""

from __future__ import annotations

import queue
import threading
import weakref
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..core.env import tree_map

__all__ = [
    "DatasetIterator",
    "DatasetBatchIterator",
    "BufferedIterator",
    "DataLoader",
    "BankRotator",
]

_SENTINEL = object()


class DatasetIterator:
    """Infinite i.i.d. sampling with replacement: yields (item, index)."""

    def __init__(self, dataset, seed: int = 0, restrict_indices_to=None):
        self._dataset = dataset
        self._rng = np.random.default_rng(seed)
        self._restrict = (
            None if restrict_indices_to is None else np.asarray(restrict_indices_to)
        )

    def __iter__(self):
        return self

    def __next__(self):
        if self._restrict is not None:
            idx = self._rng.choice(self._restrict)
        else:
            idx = self._rng.integers(0, len(self._dataset))
        return self._dataset[int(idx)], idx


class DatasetBatchIterator:
    """Batched variant: yields (dataset[indices], indices)."""

    def __init__(self, dataset, batch_size: int = 1, seed: int = 0,
                 restrict_indices_to=None):
        self._dataset = dataset
        self._rng = np.random.default_rng(seed)
        self._batch_size = batch_size
        self._restrict = (
            None if restrict_indices_to is None else np.asarray(restrict_indices_to)
        )

    def __iter__(self):
        return self

    def __next__(self):
        if self._restrict is not None:
            idx = self._rng.choice(self._restrict, self._batch_size)
        else:
            idx = self._rng.integers(0, len(self._dataset), self._batch_size)
        return self._dataset[idx], idx


def _put_unless_stopped(q: queue.Queue, stop: threading.Event, item) -> None:
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return
        except queue.Full:
            continue


class BufferedIterator:
    """A daemon thread fills a bounded queue from ``inner``; an exception
    raised by ``inner`` is forwarded through the queue and re-raised by
    ``next``."""

    def __init__(self, inner: Iterator, buffer_size: int = 128):
        self._inner = inner
        self._queue: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()
        self._finalizer = weakref.finalize(self, self._stop.set)

    def _fill(self):
        while not self._stop.is_set():
            try:
                item = next(self._inner)
            except BaseException as e:  # noqa: BLE001 — forwarded to the consumer
                _put_unless_stopped(self._queue, self._stop, (_SENTINEL, e))
                return
            _put_unless_stopped(self._queue, self._stop, (None, item))

    def __iter__(self):
        return self

    def __next__(self):
        marker, item = self._queue.get()
        if marker is _SENTINEL:
            raise item
        return item

    def close(self):
        self._stop.set()


class DataLoader:
    """Optional-prefetch wrapper."""

    def __init__(self, iterator: Iterator, prefetch: bool = True,
                 prefetch_buffer_size: int = 128):
        self._iterator = (
            BufferedIterator(iterator, prefetch_buffer_size) if prefetch else iterator
        )

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._iterator)

    def close(self):
        if isinstance(self._iterator, BufferedIterator):
            self._iterator.close()


def _map_arrays(fn, tree):
    """Map ``fn`` over the numpy-array leaves of nested dicts, tuples and
    lists (a host slab)."""
    if isinstance(tree, dict):
        return {k: _map_arrays(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_arrays(fn, v) for v in tree)
    return fn(np.asarray(tree))


class BankRotator:
    """Double-buffered device bank rotation for corpora larger than device
    memory.

    A background thread calls ``loader()`` for the next host slab (a tree
    of numpy arrays: dicts, tuples, lists), turns each array into a pinned
    tensor and copies it to ``device`` with ``non_blocking=True`` on a CUDA
    stream of its own, recording an event after the copies. ``swap()``
    takes that slab, makes the current stream wait on the event, marks
    each tensor as used by the current stream (``record_stream``) and
    returns the device tree; the thread then stages the next slab while
    the envs sample this one.

    At most one staged bank exists besides the current one: the thread
    starts loading a slab only after ``swap()`` has taken the previous one,
    so the device holds at most two banks from this rotator (plus whatever
    the caller still references). Pinning happens in the thread, never in
    ``swap()``. On a CPU ``device`` the copy is a plain host copy.

    An exception raised by ``loader`` (or by the staging) is re-raised by
    the next ``swap()``. ``last_copy_events`` are the CUDA events (timing
    enabled) recorded on the side stream before and after the last swapped
    slab's host-to-device copies, to time them or place them on the
    device's timeline; None on the CPU and before the first swap.
    """

    def __init__(self, loader: Callable[[], Any], device="cuda"):
        self._device = torch.device(device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BankRotator was asked for a CUDA device and none is available; "
                               "pass device='cpu' for host banks")
        self._loader = loader
        self._queue: queue.Queue = queue.Queue(maxsize=1)
        self._slot = threading.Semaphore(1)  # one staged bank at a time
        self._stop = threading.Event()
        self.last_copy_events = None
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()
        self._finalizer = weakref.finalize(self, self._stop.set)

    def _work(self):
        stream = torch.cuda.Stream(self._device) if self._device.type == "cuda" else None
        while not self._stop.is_set():
            if not self._slot.acquire(timeout=0.1):
                continue
            try:
                staged = self._stage(self._loader(), stream)
            except BaseException as e:  # noqa: BLE001 — forwarded to swap()
                _put_unless_stopped(self._queue, self._stop, (_SENTINEL, e))
                return
            _put_unless_stopped(self._queue, self._stop, (None, staged))

    def _stage(self, slab, stream):
        if stream is None:  # a plain copy, never sharing the loader's arrays
            return _map_arrays(lambda a: torch.tensor(a, device=self._device), slab), None
        pinned = _map_arrays(lambda a: torch.from_numpy(np.ascontiguousarray(a)).pin_memory(),
                             slab)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            start.record(stream)
            tree = tree_map(lambda t: t.to(self._device, non_blocking=True), pinned)
            done.record(stream)
        return tree, (start, done)

    def swap(self):
        """Blocks until the next slab is staged; returns it on the device."""
        marker, item = self._queue.get()
        if marker is _SENTINEL:
            raise item
        tree, events = item
        if events is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(events[1])
            tree_map(lambda t: t.record_stream(current), tree)
        self.last_copy_events = events
        self._slot.release()  # the thread may stage the next slab now
        return tree

    def close(self):
        self._stop.set()

