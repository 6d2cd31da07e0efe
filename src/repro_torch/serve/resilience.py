"""Resilience primitives for the serving stack: retry, deadline, breaker.

The policies are deliberately small and injectable — every source of
nondeterminism (sleep, clock, jitter randomness) is a constructor
argument, so tests drive them with virtual clocks and zero-length sleeps
while production uses the real ones.

  * :class:`RetryPolicy` — bounded attempts with exponential backoff and
    seeded jitter.  Retries any exception in ``retry_on`` except the
    explicit ``no_retry`` types (a :class:`DeadlineExceeded` or an
    upstream ``ShardUnavailable`` must propagate, not burn attempts).
  * :class:`Deadline` — a per-batch time budget.  Backoff sleeps never
    overshoot it, and ``check()`` raises :class:`DeadlineExceeded` once
    it is spent, turning a slow failing dependency into a prompt
    degraded answer instead of an unbounded stall.
  * :class:`CircuitBreaker` — per-shard closed/open/half-open state.
    ``failure_threshold`` consecutive dispatch failures open the
    breaker; while open, calls fail fast (no device dispatch, no retry
    burn) until ``cooldown_s`` has elapsed, then a single half-open
    trial either closes it or re-opens it.  The serving layer keeps one
    breaker per shard so a dead shard degrades only its own subspace.
  * :class:`TableLock` — a writer-preferring readers-writer lock.  The
    async frontend races device dispatches (readers of the host
    ``NodeTable``) against adaptive refinement (``graft`` /
    ``apply_delta`` / ``compact`` — writers); the lock makes that safe
    while keeping the common read path concurrent.  Writer preference
    means a query storm cannot starve refinement.

This module is the PyTorch port's own copy of the JAX package's
``repro/serve/resilience.py``; its lock reports to the port's
``analysis/runtime.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import zlib
from typing import Callable, Optional

import numpy as np

from ..analysis import runtime as _san


def _call_id(key) -> int:
    """Stable 32-bit id for a retry call site (pure function of the key)."""
    if key is None:
        return 0
    if isinstance(key, (int, np.integer)):
        return int(key) & 0xFFFFFFFF
    return zlib.crc32(repr(key).encode()) & 0xFFFFFFFF


class DeadlineExceeded(RuntimeError):
    """The per-batch time budget is spent."""


class RetryExhausted(RuntimeError):
    """Every attempt failed; ``__cause__`` is the last failure."""

    def __init__(self, attempts: int, last: BaseException):
        self.attempts = attempts
        super().__init__(
            f"all {attempts} attempts failed "
            f"(last: {type(last).__name__}: {last})"
        )


class Deadline:
    """Monotonic time budget; ``Deadline(None)`` never expires."""

    def __init__(self, seconds: Optional[float],
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.seconds = seconds
        self._t0 = clock()

    def remaining(self) -> float:
        if self.seconds is None:
            return float("inf")
        return self.seconds - (self.clock() - self._t0)

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self) -> None:
        if self.expired:
            raise DeadlineExceeded(
                f"batch deadline of {self.seconds}s exceeded"
            )


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retries with exponential backoff + seeded jitter.

    Attempt ``i`` (0-based) sleeps ``base_delay_s * backoff**i`` scaled
    by a jitter factor drawn uniformly from ``[1 - jitter, 1 + jitter]``,
    capped at ``max_delay_s`` and at the deadline's remaining budget.
    ``max_attempts=1`` means no retries.

    The jitter draw is a *pure function* of ``(seed, call-id, attempt)``
    — there is no shared rng stream, so concurrent :meth:`call`\\ s from
    the async frontend's worker threads see the same delays no matter
    how the scheduler interleaves them.  Callers that run concurrently
    pass distinct ``call_key``\\ s (e.g. the shard id) to decorrelate
    their jitter; the key is hashed stably, never by ``id()``.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.0      # serving tests want zero-cost retries
    backoff: float = 2.0
    max_delay_s: float = 1.0
    jitter: float = 0.5
    seed: int = 0
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")

    def delay(self, attempt: int, call_id: int = 0) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        raw = self.base_delay_s * (self.backoff ** (attempt - 1))
        if raw <= 0.0:
            return 0.0
        rng = np.random.default_rng([self.seed, call_id, attempt])
        factor = 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return float(min(raw * max(factor, 0.0), self.max_delay_s))

    def call(
        self,
        fn: Callable,
        *,
        retry_on: tuple = (Exception,),
        no_retry: tuple = (DeadlineExceeded,),
        deadline: Optional[Deadline] = None,
        on_retry: Optional[Callable[[int, BaseException], None]] = None,
        call_key=None,
    ):
        """Run ``fn`` under the policy; raises :class:`RetryExhausted`
        (with the last failure as ``__cause__``) when attempts run out,
        or :class:`DeadlineExceeded` when the budget is spent first."""
        cid = _call_id(call_key)
        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            if deadline is not None:
                deadline.check()
            try:
                return fn()
            except no_retry:
                raise
            except retry_on as e:
                last = e
                if attempt == self.max_attempts:
                    break
                if on_retry is not None:
                    on_retry(attempt, e)
                pause = self.delay(attempt, cid)
                if deadline is not None:
                    deadline.check()
                    pause = min(pause, max(deadline.remaining(), 0.0))
                if pause > 0.0:
                    self.sleep(pause)
        raise RetryExhausted(self.max_attempts, last) from last


class CircuitBreaker:
    """Per-dependency closed / open / half-open gate.

    ``record_failure`` counts *consecutive* failures (each already
    retry-exhausted by the caller); at ``failure_threshold`` the breaker
    opens and :meth:`allow` fails fast until ``cooldown_s`` of the
    injected clock has passed, after which exactly one half-open trial
    is admitted — success closes the breaker, failure re-opens it for
    another cooldown.
    """

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self.state = "closed"
        self.failures = 0            # consecutive
        self.opened_at: Optional[float] = None
        self.open_count = 0          # times the breaker tripped open

    def allow(self) -> bool:
        if self.state == "closed":
            return True
        if self.state == "open":
            if self.clock() - self.opened_at >= self.cooldown_s:
                self.state = "half_open"
                return True
            return False
        return False  # half_open: the single trial is already in flight

    def record_success(self) -> None:
        self.state = "closed"
        self.failures = 0
        self.opened_at = None

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.failure_threshold:
            if self.state != "open":
                self.open_count += 1
            self.state = "open"
            self.opened_at = self.clock()

    def reset(self) -> None:
        """Force-close (the repair path: the shard was just rebuilt)."""
        self.record_success()


class TableLock:
    """Writer-preferring readers-writer lock for the serving-time table.

    Device dispatches and cold-mask computations *read* the host
    ``NodeTable``; adaptive refinement (``graft``), delta uploads, shard
    re-exports, ``compact`` row remaps, and shard ``repair`` *write* it.
    Before this lock the adaptive path mutated the table with no
    synchronization at all — safe only because ``DeviceQueryServer`` was
    called from one thread; the async frontend overlaps a device worker
    with host refinement, so the races became real.

    Semantics: any number of concurrent readers, one writer, and a
    waiting writer blocks *new* readers (writer preference — a query
    storm cannot starve refinement).  Not reentrant: a thread must
    never nest acquisitions, which the serving code honors by releasing
    its read section before entering a write section.

    Under ``REPRO_SANITIZE=1`` every acquisition reports to
    :mod:`repro_torch.analysis.runtime` *before blocking*: same-thread
    re-entry and cross-lock acquisition-order inversions raise instead
    of deadlocking, and :meth:`held_write` lets guarded mutators assert
    the writer section is really held by the calling thread.
    """

    def __init__(self, name: str = "table_lock"):
        self.name = name
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writer_thread = None
        self._writers_waiting = 0

    def held_write(self) -> bool:
        """True iff the *calling thread* holds the writer section."""
        return self._writer and self._writer_thread == threading.get_ident()

    @contextlib.contextmanager
    def read(self):
        _san.note_acquire(self, "read", self.name)
        try:
            with self._cond:
                while self._writer or self._writers_waiting:
                    self._cond.wait()
                self._readers += 1
            try:
                yield
            finally:
                with self._cond:
                    self._readers -= 1
                    if self._readers == 0:
                        self._cond.notify_all()
        finally:
            _san.note_release(self)

    @contextlib.contextmanager
    def write(self):
        _san.note_acquire(self, "write", self.name)
        try:
            with self._cond:
                self._writers_waiting += 1
                try:
                    while self._writer or self._readers:
                        self._cond.wait()
                finally:
                    self._writers_waiting -= 1
                self._writer = True
                self._writer_thread = threading.get_ident()
            try:
                yield
            finally:
                with self._cond:
                    self._writer = False
                    self._writer_thread = None
                    self._cond.notify_all()
        finally:
            _san.note_release(self)
