"""The ``REPRO_SANITIZE=1`` concurrency sanitizer (dynamic side).

Three runtime checks, all zero-cost when disabled (one module-level
boolean test per hook):

* **guarded mutators** — the serving layer binds its shared mutable
  objects (``NodeTable``, ``StreamingIndex``, ``DeviceMirror``) to the
  server's ``TableLock`` via :func:`bind`; their mutator entry points
  call :func:`check_write`, which raises :class:`SanitizerError` when
  the current thread does not hold the writer lock.  This is the
  dynamic completion of the static lock checker: closures and
  cross-file call chains the AST pass cannot follow are caught here.
* **held-state tracking** — ``TableLock`` reports acquisitions to
  :func:`note_acquire` / :func:`note_release` *before blocking*, so a
  same-thread re-acquisition (TableLock is not reentrant — nesting
  self-deadlocks) raises :class:`LockOrderError` instead of hanging the
  suite.
* **lock-order graph** — every acquisition records held-lock → new-lock
  edges in a global directed graph; acquiring L while holding H when the
  graph already shows a path L → H is a potential deadlock (some thread
  took the locks in the opposite order) and raises
  :class:`LockOrderError` naming both locks.

Enable with ``REPRO_SANITIZE=1`` in the environment, or
programmatically via :func:`enable` / :func:`disable` in tests.

This module is the PyTorch port's own copy of the JAX package's
``repro/analysis/runtime.py``, unchanged.  The two copies keep separate
state: enabling one does not enable the other.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

__all__ = [
    "SanitizerError", "LockOrderError", "enabled", "enable", "disable",
    "reset", "bind", "check_write", "note_acquire", "note_release",
]


class SanitizerError(AssertionError):
    """A guarded mutator ran without the writer lock held."""


class LockOrderError(AssertionError):
    """Same-lock re-entry or a lock-acquisition-order inversion."""


_enabled = os.environ.get("REPRO_SANITIZE", "0") not in ("", "0", "false")

_tls = threading.local()            # .held: list of (lock_id, mode, name)
_graph_mu = threading.Lock()
# lock_id -> {successor_lock_id: (held_name, acquired_name)}
_edges: dict[int, dict[int, tuple]] = {}


def enabled() -> bool:
    return _enabled


def enable() -> bool:
    """Turn the sanitizer on (tests); returns the previous state."""
    global _enabled
    prev, _enabled = _enabled, True
    return prev


def disable() -> bool:
    global _enabled
    prev, _enabled = _enabled, False
    return prev


def reset() -> None:
    """Clear the lock-order graph and this thread's held list (tests)."""
    with _graph_mu:
        _edges.clear()
    _tls.held = []


def _held() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _reaches(src: int, dst: int) -> bool:
    """DFS: does the recorded graph contain a path src -> dst?"""
    seen = {src}
    stack = [src]
    while stack:
        cur = stack.pop()
        if cur == dst:
            return True
        for nxt in _edges.get(cur, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return False


def note_acquire(lock, mode: str, name: Optional[str] = None) -> None:
    """Called by the lock *before it blocks*.  Raises instead of letting
    the thread deadlock."""
    if not _enabled:
        return
    name = name or getattr(lock, "name", None) or type(lock).__name__
    held = _held()
    for lid, _m, nm in held:
        if lid == id(lock):
            raise LockOrderError(
                f"re-entrant acquisition of non-reentrant lock '{name}' "
                f"(mode={mode}) — already held by this thread; this "
                f"self-deadlocks without the sanitizer")
    if held:
        with _graph_mu:
            new_id = id(lock)
            for lid, _m, nm in held:
                # inversion: some earlier acquisition recorded new -> held
                if _reaches(new_id, lid):
                    raise LockOrderError(
                        f"lock-order inversion: acquiring '{name}' while "
                        f"holding '{nm}', but the acquisition graph "
                        f"already orders '{name}' before '{nm}' — "
                        f"potential deadlock")
            for lid, _m, nm in held:
                _edges.setdefault(lid, {})[new_id] = (nm, name)
    held.append((id(lock), mode, name))


def note_release(lock) -> None:
    if not _enabled:
        return
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] == id(lock):
            del held[i]
            return


def bind(obj, lock) -> None:
    """Associate a shared mutable object with its guarding TableLock.
    Objects without a ``_san_lock`` slot are skipped silently."""
    try:
        obj._san_lock = lock
    except AttributeError:
        pass


def check_write(obj, op: str) -> None:
    """Assert the current thread holds the writer lock the object was
    bound to.  No-op when the sanitizer is off or the object is unbound
    (boot-time construction happens before publication)."""
    if not _enabled:
        return
    lock = getattr(obj, "_san_lock", None)
    if lock is None:
        return
    if not lock.held_write():
        raise SanitizerError(
            f"{type(obj).__name__}.{op}() mutated shared state without "
            f"the writer lock held (REPRO_SANITIZE) — serialize through "
            f"'with table_lock.write():'")
