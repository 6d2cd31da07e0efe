"""Spans around the calls into the program's layers, and the reduction of
a ``torch.profiler`` trace to device busy time, idle gaps and kernel times.

The spans wrap the program's functions from outside (the program itself
is not edited): a span adds its host seconds to a total and, through
``record_function``, marks its range in a trace, so that an idle gap of
the device can be named by the host span it fell in.
"""
from __future__ import annotations

import bisect
import collections
import re
import time

import torch

PREFIX = "portbench."
TRACED = PREFIX + "traced"


class Spans:
    """Host seconds per span name."""

    def __init__(self):
        self.total = collections.defaultdict(float)
        self._undo = []

    def span(self, name: str):
        return _Span(self, PREFIX + name)

    def wrap(self, owner, attr: str, name: str) -> None:
        """Replace ``owner.attr`` by a spanned call until :meth:`restore`."""
        fn = getattr(owner, attr)
        spans = self

        def call(*args, **kw):
            with spans.span(name):
                return fn(*args, **kw)

        setattr(owner, attr, call)
        self._undo.append((owner, attr, fn))

    def restore(self) -> None:
        while self._undo:
            owner, attr, fn = self._undo.pop()
            setattr(owner, attr, fn)

    def seconds(self, name: str) -> float:
        return self.total.get(PREFIX + name, 0.0)


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spans.total[self.name] += time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        return False


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(spans, starts, t) -> str:
    """The span holding ``t`` that started last: spans of one thread nest,
    so it is the innermost."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if spans[i][1] >= t:
            return spans[i][2]
        i -= 1
    return PREFIX + "outside_spans"


def reduce(prof) -> dict | None:
    """From a finished profiler holding one ``portbench.traced`` range:
    ``window_s``, ``busy_s`` (the union of device operations inside it),
    device seconds and counts by operation name, and idle seconds by the
    innermost host span the gap's midpoint fell in.  None when the trace
    holds no such range or no device operation."""
    events = prof.events()
    win = [e for e in events if e.name == TRACED and e.device_type == torch.autograd.DeviceType.CPU]
    if not win:
        return None
    ws, we = win[0].time_range.start, win[0].time_range.end
    dev, spans = [], []
    for e in events:
        a, b = max(e.time_range.start, ws), min(e.time_range.end, we)
        if e.device_type == torch.autograd.DeviceType.CPU:
            if e.name.startswith(PREFIX) and e.name != TRACED and b > a:
                spans.append((e.time_range.start, e.time_range.end, e.name))
        elif (e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith(PREFIX) and b > a):
            dev.append((a, b, e.name))
    if not dev:
        return None
    busy = _union([(a, b) for a, b, _ in dev])
    ops_s = collections.defaultdict(float)
    ops_n = collections.defaultdict(int)
    for a, b, name in dev:
        ops_s[name] += (b - a) * 1e-6
        ops_n[name] += 1
    gaps = collections.defaultdict(float)
    spans.sort()
    starts = [s[0] for s in spans]
    edges = [ws] + [x for iv in busy for x in iv] + [we]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps[_innermost(spans, starts, (a + b) / 2)] += (b - a) * 1e-6
    top = lambda d: [[_short(k), v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {
        "window_s": (we - ws) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "ops_s": dict(ops_s),
        "ops_n": dict(ops_n),
        "breakdown": {"device_ops": top(ops_s), "idle_gaps": top(gaps)},
    }


def op_seconds(red: dict, pattern: str) -> float:
    """Device seconds of the operations whose name holds ``pattern``."""
    return sum(s for name, s in red["ops_s"].items() if pattern in name)


def op_count(red: dict, pattern: str) -> int:
    return sum(n for name, n in red["ops_n"].items() if pattern in name)
