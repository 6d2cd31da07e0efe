"""Deterministic, seeded fault-injection plane for the serving stack.

Production serving means partial failure is the normal case: a shard
dispatch times out, a host/device upload is interrupted, the cold-path
refiner's backing store hiccups, a snapshot write is torn mid-file.  This module makes those failures *injectable,
reproducible events* so every chaos run is replayable in CI: a
:class:`FaultPlan` is armed at named failure points across the stack and
fires :class:`FaultError` on a schedule that is a pure function of
``(seed, rule, call index)`` — never of wall clock, never of interleaving
across points.

Failure points (the names the serving stack fires; see
``serve/engine.py`` for where each is armed):

  * ``shard_dispatch``   — per-shard compiled query dispatch (ctx: shard)
  * ``apply_delta``      — host -> device leaf-block upload / shard refresh
  * ``host_refine``      — the cold-path host AMBI engine call
  * ``pagestore_read``   — simulated disk reads (``PageStore.fault_hook``)
  * ``snapshot_save``    — durable snapshot barrier write
  * ``snapshot_load``    — snapshot read at recovery time
  * ``journal_append``   — graft-journal record append
  * ``admission``        — async-frontend request admission (ctx: kind)
  * ``batch_close``      — async-frontend microbatch close/dispatch

A plan can schedule faults two ways, per rule: an explicit ``at_calls``
set (fire on exactly those 1-based call indices at the point — the
boundary-sweep tests use this) or a seeded Bernoulli ``rate`` (each
matching call draws from a per-rule ``np.random.default_rng([seed, rule])``
stream — the chaos parity run uses this).  Every fired fault is recorded
in :attr:`FaultPlan.log` so a failing chaos run prints the exact schedule
that produced it.

This module is the PyTorch port's own copy of the JAX package's
``repro/serve/faults.py``, unchanged.  The port's ``DeviceQueryServer``
fires ``shard_dispatch``, ``apply_delta``, ``host_refine`` and (through
the page store) ``pagestore_read``; the other points wait for the
streaming, durability and frontend layers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

FAILURE_POINTS = (
    "shard_dispatch",
    "apply_delta",
    "host_refine",
    "pagestore_read",
    "snapshot_save",
    "snapshot_load",
    "journal_append",
    "admission",
    "batch_close",
)


class FaultError(RuntimeError):
    """An injected (transient) fault.  The resilience layer treats it like
    any other dispatch failure: retried, then breaker-counted."""

    def __init__(self, point: str, call_no: int, ctx: dict):
        self.point = point
        self.call_no = call_no
        self.ctx = dict(ctx)
        super().__init__(
            f"injected fault at {point!r} (call #{call_no}"
            + (f", ctx={ctx}" if ctx else "")
            + ")"
        )


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One scheduled failure source at one failure point.

    ``at_calls`` fires on exactly those 1-based *matching-call* indices;
    otherwise ``rate`` is a per-call Bernoulli drawn from the rule's own
    seeded stream.  ``match`` restricts the rule to calls whose context
    contains the given items (e.g. ``{"shard": 2}`` fails one shard only);
    non-matching calls neither fire nor advance the rule's counters.
    ``max_fires`` caps total fires — the standard way to build a fault a
    bounded retry policy is guaranteed to outlast.
    """

    point: str
    at_calls: Optional[frozenset] = None
    rate: float = 0.0
    match: Optional[tuple] = None  # ((key, value), ...) context filter
    max_fires: Optional[int] = None

    def __post_init__(self):
        if self.point not in FAILURE_POINTS:
            raise ValueError(
                f"unknown failure point {self.point!r}; "
                f"expected one of {FAILURE_POINTS}"
            )
        if self.at_calls is not None:
            object.__setattr__(self, "at_calls", frozenset(
                int(c) for c in self.at_calls
            ))
        if self.match is not None:
            object.__setattr__(
                self, "match", tuple(sorted(dict(self.match).items()))
            )

    def matches(self, ctx: dict) -> bool:
        if self.match is None:
            return True
        return all(ctx.get(k) == v for k, v in self.match)


class FaultPlan:
    """A seeded, replayable schedule of injected faults.

    Construction is cheap and stateless-looking: all mutable state is the
    per-rule matching-call counters, so re-running the *same* serving
    sequence against a fresh plan with the same seed reproduces the same
    faults bit for bit.  ``fire(point, **ctx)`` is the single hook the
    stack calls; it raises :class:`FaultError` when any armed rule is
    scheduled for this call.

    ``disarm()``/``rearm()`` gate the whole plane (recovery replay runs
    with the plane disarmed so replay is never re-faulted), and
    ``pagestore_hook()`` adapts the plane onto
    ``PageStore.fault_hook``'s ``(op, n)`` calling convention.
    """

    def __init__(self, rules=(), *, seed: int = 0):
        self.seed = int(seed)
        self.rules = tuple(rules)
        self._calls = [0] * len(self.rules)          # matching calls seen
        self._fires = [0] * len(self.rules)
        self._rngs = [
            np.random.default_rng([self.seed, i])
            for i in range(len(self.rules))
        ]
        self.log: list[tuple[str, int, dict]] = []   # fired faults, in order
        self.armed = True

    # -- convenience constructors ------------------------------------------
    @classmethod
    def single(cls, point: str, at_call: int = 1, **kw) -> "FaultPlan":
        """Fire once, on the ``at_call``-th call at ``point``."""
        return cls([FaultRule(point, at_calls=frozenset([at_call]))], **kw)

    @classmethod
    def storm(cls, points, rate: float, *, seed: int = 0,
              max_fires_per_point: Optional[int] = None) -> "FaultPlan":
        """Seeded Bernoulli faults at several points at once (chaos runs)."""
        return cls(
            [
                FaultRule(p, rate=rate, max_fires=max_fires_per_point)
                for p in points
            ],
            seed=seed,
        )

    # -- arming -------------------------------------------------------------
    def disarm(self) -> None:
        self.armed = False

    def rearm(self) -> None:
        self.armed = True

    @property
    def total_fires(self) -> int:
        return len(self.log)

    def fires_at(self, point: str) -> int:
        return sum(1 for p, _, _ in self.log if p == point)

    # -- the hook ------------------------------------------------------------
    def fire(self, point: str, **ctx) -> None:
        """Advance every matching rule's schedule; raise if one is due.

        Counters advance even when the plan is disarmed *only* for armed
        plans — a disarmed plan is inert, so recovery replay neither
        faults nor perturbs the schedule the live path will see.
        """
        if not self.armed:
            return
        due = None
        for i, rule in enumerate(self.rules):
            if rule.point != point or not rule.matches(ctx):
                continue
            self._calls[i] += 1
            if rule.max_fires is not None and self._fires[i] >= rule.max_fires:
                continue
            if rule.at_calls is not None:
                hit = self._calls[i] in rule.at_calls
            else:
                hit = bool(rule.rate) and (
                    self._rngs[i].random() < rule.rate
                )
            if hit:
                self._fires[i] += 1
                due = (point, self._calls[i], ctx)
        if due is not None:
            self.log.append(due)
            raise FaultError(*due)

    def pagestore_hook(self):
        """Adapter for ``PageStore.fault_hook``: fires ``pagestore_read``
        for read-side ops before any I/O is accounted."""

        def hook(op: str, n: int) -> None:
            if op.startswith("read"):
                self.fire("pagestore_read", op=op, pages=int(n))

        return hook
