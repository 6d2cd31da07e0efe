"""Spans and counters of the port, kept in memory.

``span(name)`` times a region of the host's work.  Off (the default) it
returns one shared no-op context: it takes no clock, allocates nothing
and does not touch ``torch.profiler``.  On (:func:`enable`) it records
the name, start and end (``time.perf_counter_ns``), the enclosing span
and a request id (spans of one request share the id; the outermost span
opens a new one), and enters
``torch.profiler.record_function("repro_torch." + name)``, so that a
profiler running at the same time shows the span on its own timeline and
clock, where an idle gap of the device can be named by the span the host
was in.  A span never synchronises the device: it times the host.  Each
thread keeps its own stack of open spans.  The last ``KEEP_REQUESTS``
top-level requests are kept whole (:func:`requests`); the totals per name
(calls, seconds, self seconds: the duration less the direct children's)
are never dropped (:func:`totals`).

``count(name, n)`` adds to one process-wide registry of integer counters,
always on; the kernels' launch counts live there too, under
``launch.<kernel>`` (``kernels/launches.py``).  :func:`reset` zeroes
spans and counters.  Nothing is written to a file.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time

import torch

PREFIX = "repro_torch."
KEEP_REQUESTS = 4096


@dataclasses.dataclass(slots=True)
class Span:
    """One closed (or still open) span of a request."""
    name: str
    request: int
    parent: int | None     # index of the enclosing span in the request's list
    start_ns: int
    end_ns: int = 0
    child_ns: int = 0      # summed durations of the direct children

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    @property
    def self_seconds(self) -> float:
        return (self.end_ns - self.start_ns - self.child_ns) * 1e-9


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_on = False
_lock = threading.Lock()
_local = threading.local()
_request_ids = itertools.count(1)
_counters: dict[str, int] = {}
_totals: dict[str, list] = {}      # name -> [calls, ns, self ns]
_kept: collections.deque = collections.deque(maxlen=KEEP_REQUESTS)


class _On:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> Span:
        stack = getattr(_local, "stack", None)
        if not stack:
            _local.stack = stack = []
            _local.records = []
            request, parent = next(_request_ids), None
        else:
            parent = stack[-1]
            request = _local.records[parent].request
        records = _local.records
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        self.rec = Span(self.name, request, parent, time.perf_counter_ns())
        stack.append(len(records))
        records.append(self.rec)
        return self.rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.end_ns = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        stack, records = _local.stack, _local.records
        stack.pop()
        ns = rec.end_ns - rec.start_ns
        if rec.parent is not None:
            records[rec.parent].child_ns += ns
        with _lock:
            tot = _totals.setdefault(rec.name, [0, 0, 0])
            tot[0] += 1
            tot[1] += ns
            tot[2] += ns - rec.child_ns
            if not stack:
                _kept.append(tuple(records))
        return False


def span(name: str):
    """A context manager timing the host over its body while tracing is on
    (see the module's docstring); a shared no-op while it is off."""
    if not _on:
        return _OFF
    return _On(name)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter."""
    with _lock:
        return dict(_counters)


def totals() -> dict:
    """Per span name: ``calls``, ``seconds`` and ``self_seconds``, over
    every span closed since the last :func:`reset`."""
    with _lock:
        return {name: {"calls": c, "seconds": ns * 1e-9, "self_seconds": own * 1e-9}
                for name, (c, ns, own) in _totals.items()}


def requests() -> list:
    """The last ``KEEP_REQUESTS`` top-level requests, oldest first, each a
    tuple of its spans in the order they opened (the root first)."""
    with _lock:
        return list(_kept)


def zero_counters(prefix: str) -> None:
    """Zero the counters whose names start with ``prefix``."""
    with _lock:
        for name in _counters:
            if name.startswith(prefix):
                _counters[name] = 0


def reset() -> None:
    """Zero every counter and drop every span total and kept request."""
    with _lock:
        _counters.clear()
        _totals.clear()
        _kept.clear()
