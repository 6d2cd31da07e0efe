"""Async serving frontend: admission control, deadline-aware microbatching,
load shedding, and certified brownout in front of ``DeviceQueryServer``.

The resilience plane makes the server survive *failures*; this layer
makes it survive *overload* — the other half of production robustness.
The shape follows the contention analysis of *Main Memory Adaptive
Indexing for Multi-core Systems* (PAPERS.md): the device hot path and the
host cold path (adaptive refinement) are different resources, so the
frontend overlaps them instead of serializing one behind the other.

The pipeline, request by request:

  * **Admission** — a *bounded* queue.  A submit that would exceed
    ``queue_bound`` is rejected immediately with a reason and a
    root-MBB :class:`CompletenessCertificate` (the honest "we answered
    nothing" answer) — the queue can never grow without bound, so an
    overloaded server degrades with certificates instead of OOMing or
    stalling every client behind an unbounded backlog.
  * **Batch forming** — per lane (windows; k-NN per ``k``), a microbatch
    closes at ``batch_max`` queued requests *or* once the oldest member
    has waited ``batch_window_s``, whichever comes first.  Closed
    batches go to the device worker as one dispatch; the engine pads
    them to the pow2 bucket shapes it already compiles for, so drifting
    batch sizes reuse a bounded set of compiled variants.
  * **Deadlines** — each request may carry a deadline; one expired in
    the queue is shed (with a certificate) at batch close, and the
    dispatched batch carries a :class:`Deadline` equal to the tightest
    member's remaining budget, threading into the engine's existing
    retry/breaker machinery.
  * **Brownout** — when queue depth crosses ``brownout_high`` the
    frontend degrades: k-NN escalation is capped at
    ``brownout_knn_rounds`` (best-effort answers marked
    ``certified_exact=False``), dispatch optionally reroutes to a
    compressed/fused ``brownout_server`` twin, and an adaptive server
    answers device-only (``window_hot``/``knn_hot``): cold queries get
    their refined-subset hits plus a certificate naming the unrefined
    subspaces instead of a multi-ms host refinement.  Depth back under
    ``brownout_low`` exits brownout — the watermark gap is the
    hysteresis that keeps the tier from flapping.
  * **Overlap** — outside brownout an adaptive window batch is split by
    the cheap host-side cold test (``cold_window_mask``): the hot part
    runs on the device lane while the cold part refines on the refine
    lane concurrently, both behind the server's table RW-lock.

Everything nondeterministic is injectable: the clock (``VirtualClock``
for saturation tests — the same burst replays bit-identically), the
executors (``InlineExecutor`` runs lanes synchronously on the pump
thread; ``WorkerExecutor`` is the production daemon-thread lane), and
the fault plane (``admission`` / ``batch_close`` failure points).  In
real-time mode :meth:`start` owns a dispatcher thread that forms and
dispatches batches; in virtual mode the test (or the open-loop load
generator) drives :meth:`pump` explicitly.

This module is the PyTorch port's copy of the JAX package's
``repro/serve/frontend.py`` with one departure: only an injected fault
is retried or shed.  The reference retries any exception of a dispatch
and sheds the batch, and sheds a refinement on any exception, so a
kernel or CUDA error would come back as a shed request with a
certificate.  Here a dispatch retries only a :class:`FaultError` (or the
:class:`ShardUnavailable` outage that injected faults leave behind the
server's own retries), and any other error ends the batch's requests in
the terminal state ``error`` (the exception kept on the request) and is
raised to the caller: from :meth:`Frontend.pump` in virtual mode, from
:meth:`Frontend.drain` and :meth:`Frontend.stop` in real-time mode.
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np

from ..core.distributed_torch import ShardUnavailable
from .faults import FaultError
from .resilience import Deadline, DeadlineExceeded, RetryExhausted


class VirtualClock:
    """Injectable deterministic clock: saturation tests replay exactly."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError("clocks only move forward")
        self.t += float(dt)


class InlineExecutor:
    """Deterministic executor: runs each task immediately on the caller's
    thread, in submission order.  The virtual-clock tests use this for
    both lanes, so a pump() is one deterministic sequence of work."""

    def submit(self, fn: Callable[[], None]) -> None:
        fn()

    def stop(self) -> None:
        pass


class WorkerExecutor:
    """One daemon worker thread draining a FIFO task queue — the
    production lane.  ``stop()`` drains outstanding tasks, then joins."""

    def __init__(self, name: str = "frontend-lane"):
        self._q: _queue.Queue = _queue.Queue()
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
            finally:
                self._q.task_done()

    def submit(self, fn: Callable[[], None]) -> None:
        self._q.put(fn)

    def stop(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=30.0)


@dataclasses.dataclass
class FrontendStats:
    submitted: int = 0
    admitted: int = 0
    completed: int = 0         # served (possibly brownout-degraded)
    rejected: int = 0          # admission control bounced it (queue full)
    timed_out: int = 0         # deadline expired before service
    shed: int = 0              # dispatch failure turned into certified shed
    errors: int = 0            # not an injected fault: ended, and raised
    batches: int = 0
    brownout_batches: int = 0
    refine_batches: int = 0    # cold sub-batches overlapped on refine lane
    brownout_enters: int = 0
    brownout_exits: int = 0
    depth_peak: int = 0

    @property
    def dropped(self) -> int:
        return self.rejected + self.timed_out + self.shed


class Request:
    """One admitted (or bounced) query and its eventual reply.

    ``status`` lifecycle: ``queued`` -> one of ``ok`` (served; check
    ``cert`` for brownout degradation), ``rejected`` (admission),
    ``timeout`` (deadline expired), ``shed`` (dispatch failed after
    retries), ``error`` (an error that is not an injected fault, kept in
    ``error`` and raised to the frontend's caller).  Every terminal state
    carries a certificate; only ``ok`` carries ids.  ``wait()`` blocks
    (real mode) or returns immediately after the pump served it (virtual
    mode)."""

    __slots__ = ("kind", "payload", "t_submit", "deadline", "seq",
                 "status", "reason", "ids", "cert", "brownout",
                 "t_done", "error", "_event")

    def __init__(self, kind, payload, t_submit, deadline, seq):
        self.kind = kind
        self.payload = payload
        self.t_submit = t_submit
        self.deadline = deadline
        self.seq = seq
        self.status = "queued"
        self.reason: Optional[str] = None
        self.ids: Optional[np.ndarray] = None
        self.cert = None
        self.brownout = False
        self.t_done: Optional[float] = None
        self.error: Optional[BaseException] = None
        self._event = threading.Event()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    @property
    def latency(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit


class Frontend:
    """The async admission/batching pipeline in front of a
    :class:`~repro_torch.serve.engine.DeviceQueryServer` (see module
    docstring).

    Two drive modes share one code path:

      * **real time** — ``start()`` spawns the dispatcher thread (it owns
        every device dispatch) and, for adaptive servers, a refine-lane
        worker; ``submit_*`` may be called from any thread and
        ``Request.wait()`` blocks until served.  ``stop()`` drains.
      * **virtual time** — construct with ``clock=VirtualClock()`` (and
        the default ``InlineExecutor`` lanes), never call ``start``;
        drive ``pump()``/``drain()`` explicitly.  Identical inputs give
        identical statuses, results, and certificates on every replay.
    """

    def __init__(self, server, *,
                 clock: Optional[Callable[[], float]] = None,
                 queue_bound: int = 256,
                 batch_max: Optional[int] = None,
                 batch_window_s: float = 0.002,
                 default_deadline_s: Optional[float] = None,
                 brownout_high: Optional[int] = None,
                 brownout_low: Optional[int] = None,
                 brownout_knn_rounds: int = 0,
                 brownout_server=None,
                 overlap_refine: bool = True,
                 executor=None, refine_executor=None,
                 fault_plan=None):
        if queue_bound < 1:
            raise ValueError("queue_bound must be >= 1")
        self.server = server
        self.clock = clock if clock is not None else time.monotonic
        self._virtual = clock is not None
        self.queue_bound = int(queue_bound)
        self.batch_max = int(batch_max if batch_max is not None
                             else server.microbatch)
        self.batch_window_s = float(batch_window_s)
        self.default_deadline_s = default_deadline_s
        if brownout_high is not None:
            if brownout_high > queue_bound:
                raise ValueError("brownout_high must be <= queue_bound")
            if brownout_low is None:
                brownout_low = max(brownout_high // 4, 0)
            if brownout_low >= brownout_high:
                raise ValueError(
                    "hysteresis needs brownout_low < brownout_high"
                )
        self.brownout_high = brownout_high
        self.brownout_low = brownout_low
        self.brownout_knn_rounds = int(brownout_knn_rounds)
        self.brownout_server = brownout_server
        self.overlap_refine = bool(overlap_refine)
        self.fault_plan = fault_plan
        self.stats = FrontendStats()
        self.brownout = False
        # lanes: injected executors win; else the device lane runs inline
        # on whoever pumps (the dispatcher thread in real mode) and the
        # refine lane gets its own worker under the real clock
        self._executor = executor if executor is not None else InlineExecutor()
        self._refine = refine_executor
        if self._refine is None:
            self._refine = (InlineExecutor() if self._virtual
                            else WorkerExecutor("frontend-refine"))
        # admission state, all guarded by one mutex
        self._mu = threading.Condition()
        self._queues: "OrderedDict[tuple, list]" = OrderedDict()
        self._depth = 0
        self._seq = 0
        self._stopping = False
        self._dispatcher: Optional[threading.Thread] = None
        # errors that are not injected faults, raised to the caller by
        # pump() (virtual mode) or drain()/stop() (real time)
        self._errors: list = []

    # -- admission -----------------------------------------------------------
    def submit_window(self, lo, hi, *, deadline_s: Optional[float] = None):
        lo = np.asarray(lo, dtype=np.float64).reshape(-1)
        hi = np.asarray(hi, dtype=np.float64).reshape(-1)
        self.server._validate_batch(lo[None], "lo")
        self.server._validate_batch(hi[None], "hi")
        return self._submit("window", (lo, hi), ("window",), deadline_s)

    def submit_knn(self, q, k: int, *, deadline_s: Optional[float] = None):
        q = np.asarray(q, dtype=np.float64).reshape(-1)
        self.server._validate_batch(q[None], "q")
        if not isinstance(k, (int, np.integer)) or int(k) < 1:
            raise ValueError(f"k must be a positive integer, got {k!r}")
        return self._submit("knn", (q, int(k)), ("knn", int(k)), deadline_s)

    def _submit(self, kind, payload, lane, deadline_s):
        now = self.clock()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        deadline = None if deadline_s is None else now + float(deadline_s)
        with self._mu:
            self._seq += 1
            req = Request(kind, payload, now, deadline, self._seq)
            self.stats.submitted += 1
            if self._stopping:
                self._reject(req, "frontend stopped")
                return req
            if self.fault_plan is not None:
                try:
                    self.fault_plan.fire("admission", kind=kind)
                except FaultError as e:
                    self._reject(req, f"admission fault injected: {e}")
                    return req
            if self._depth >= self.queue_bound:
                self._reject(
                    req,
                    f"queue full (depth={self._depth}, "
                    f"bound={self.queue_bound})",
                )
                return req
            self.stats.admitted += 1
            self._queues.setdefault(lane, []).append(req)
            self._depth += 1
            self.stats.depth_peak = max(self.stats.depth_peak, self._depth)
            self._update_brownout()
            self._mu.notify_all()
        return req

    def _reject(self, req, reason: str) -> None:
        self._finish_dropped(req, "rejected", reason, stat="rejected")

    def _finish_dropped(self, req, status: str, reason: str,
                        stat: Optional[str] = None,
                        error: Optional[BaseException] = None) -> bool:
        """Terminal no-answer state: empty ids, root certificate (and for
        ``error`` the exception).

        The done-check, the field writes, and the stat bump are one
        atomic section under ``_mu`` (a reentrant Condition — admission
        paths already holding it nest safely): the device lane and the
        refine lane can race to finish the same request when a retried
        dispatch overlaps refinement, and the first to claim it here
        wins — the loser neither tears the terminal state nor
        double-counts the SLO stat.  Returns whether this call won."""
        with self._mu:
            if req.done:
                return False
            if stat is not None:
                setattr(self.stats, stat, getattr(self.stats, stat) + 1)
            req.status = status
            req.reason = reason
            req.error = error
            req.ids = np.zeros(0, dtype=np.int64)
            req.cert = self.server._root_cert()
            req.t_done = self.clock()
            req._event.set()
        return True

    def _fail(self, reqs, where: str, exc: BaseException) -> None:
        """End ``reqs`` in the terminal state ``error`` and keep ``exc``
        for the caller: an error that is not an injected fault (a kernel
        that fails to build or launch, a CUDA error) is neither retried
        nor shed."""
        for r in reqs:
            self._finish_dropped(r, "error", f"{where} failed: {exc!r}",
                                 stat="errors", error=exc)
        with self._mu:
            self._errors.append(exc)

    def _raise_errors(self) -> None:
        """Raise the first error kept by :meth:`_fail` (the others stay
        on their requests)."""
        with self._mu:
            errors, self._errors = self._errors, []
        if errors:
            raise errors[0]

    @property
    def depth(self) -> int:
        with self._mu:
            return self._depth

    def _update_brownout(self) -> None:  # analysis: caller-holds-write
        """Watermark hysteresis (holding ``_mu``): enter at >= high, exit
        at <= low — depths between the watermarks keep the current tier,
        so oscillation around one threshold cannot flap the mode."""
        if self.brownout_high is None:
            return
        if not self.brownout and self._depth >= self.brownout_high:
            self.brownout = True
            self.stats.brownout_enters += 1
        elif self.brownout and self._depth <= self.brownout_low:
            self.brownout = False
            self.stats.brownout_exits += 1

    # -- batch forming -------------------------------------------------------
    def _due_lanes(self, now: float, flush: bool) -> list:
        due = []
        for lane, q in self._queues.items():
            if not q:
                continue
            if (flush or len(q) >= self.batch_max
                    or now - q[0].t_submit >= self.batch_window_s
                    or (q[0].deadline is not None
                        and now >= q[0].deadline)):
                due.append(lane)
        return due

    def _next_due(self, now: float) -> Optional[float]:
        """Earliest future instant any lane's batch will close by age."""
        nxt = None
        for q in self._queues.values():
            if not q:
                continue
            t = q[0].t_submit + self.batch_window_s
            if q[0].deadline is not None:
                t = min(t, q[0].deadline)
            nxt = t if nxt is None else min(nxt, t)
        return nxt

    def _close_batch(self, lane) -> list:  # analysis: caller-holds-write
        q = self._queues[lane]
        batch, rest = q[:self.batch_max], q[self.batch_max:]
        self._queues[lane] = rest
        self._depth -= len(batch)
        self._update_brownout()
        return batch

    # -- dispatch ------------------------------------------------------------
    def pump(self, flush: bool = False) -> int:
        """Form and dispatch every due microbatch; returns how many.

        The virtual-time drive loop: tests/load rigs interleave
        ``submit_*``, ``clock.advance``, and ``pump`` and observe a fully
        deterministic schedule.  The real-time dispatcher thread calls
        this too — same code path, real clock.  In virtual mode it raises
        the first error of a dispatch or refinement that was not an
        injected fault, once every due batch has been dispatched."""
        dispatched = 0
        while True:
            with self._mu:
                now = self.clock()
                due = self._due_lanes(now, flush)
                if not due:
                    break
                # tier decision happens at close time, while the members
                # still count toward the depth that justified degrading
                brown = self.brownout
                batches = [(lane, self._close_batch(lane)) for lane in due]
            for lane, reqs in batches:
                self._executor.submit(
                    lambda lane=lane, reqs=reqs, brown=brown: (
                        self._dispatch(lane, reqs, brown)
                    )
                )
                dispatched += 1
        if self._virtual:
            self._raise_errors()
        return dispatched

    def drain(self) -> None:
        """Flush every queued request through dispatch, then raise the
        first error that was not an injected fault."""
        while self.pump(flush=True):
            pass
        self._raise_errors()

    def _dispatch(self, lane, reqs: list, brown: bool) -> None:
        now = self.clock()
        live = []
        for r in reqs:
            if r.deadline is not None and now >= r.deadline:
                self._finish_dropped(
                    r, "timeout", "deadline expired in queue",
                    stat="timed_out",
                )
            else:
                live.append(r)
        if not live:
            return
        with self._mu:
            self.stats.batches += 1
            if brown:
                self.stats.brownout_batches += 1
        budgets = [r.deadline - now for r in live if r.deadline is not None]
        deadline = Deadline(min(budgets) if budgets else None,
                            clock=self.clock)

        def attempt():
            if self.fault_plan is not None:
                self.fault_plan.fire("batch_close", kind=lane[0])
            return self._execute(lane, live, deadline, brown)

        try:
            self.server.retry.call(
                attempt, retry_on=(FaultError, ShardUnavailable),
                no_retry=(DeadlineExceeded,),
                call_key=("batch_close", lane),
            )
        except DeadlineExceeded:
            for r in live:
                self._finish_dropped(
                    r, "timeout", "deadline exceeded during dispatch",
                    stat="timed_out",
                )
        except RetryExhausted as e:
            for r in live:
                self._finish_dropped(r, "shed", f"dispatch failed: {e}",
                                     stat="shed")
        except Exception as e:
            self._fail(live, "dispatch", e)

    def _execute(self, lane, reqs: list, deadline, brown: bool) -> None:
        """One formed microbatch against the engine.  Raises to signal a
        retryable dispatch failure; on success every request is done."""
        kind = lane[0]
        srv = self.server
        if brown and self.brownout_server is not None and not srv.adaptive:
            srv = self.brownout_server
        if kind == "window":
            los = np.stack([r.payload[0] for r in reqs])
            his = np.stack([r.payload[1] for r in reqs])
            if brown and srv.adaptive:
                res, certs = srv.window_hot(los, his, deadline=deadline)
                self._finish_batch(reqs, res, certs, brown)
            elif srv.adaptive and self.overlap_refine:
                self._execute_window_overlap(srv, reqs, los, his, deadline)
            else:
                res, certs = srv.window(los, his, return_certs=True,
                                        deadline=deadline)
                self._finish_batch(reqs, res, certs, brown)
        else:
            k = lane[1]
            qs = np.stack([r.payload[0] for r in reqs])
            if brown:
                res, certs = srv.knn_hot(
                    qs, k, deadline=deadline,
                    max_rounds=self.brownout_knn_rounds,
                )
            else:
                res, certs = srv.knn(qs, k, return_certs=True,
                                     deadline=deadline)
            self._finish_batch(reqs, res, certs, brown)

    def _execute_window_overlap(self, srv, reqs, los, his, deadline):
        """Split by the cheap host-side cold test: the hot part answers on
        this (device) lane now; the cold part refines on the refine lane,
        overlapping the next device batches instead of blocking them."""
        cold = srv.cold_window_mask(los, his)
        hot_i = np.flatnonzero(~cold)
        cold_i = np.flatnonzero(cold)
        if cold_i.size:
            cold_reqs = [reqs[i] for i in cold_i]
            with self._mu:
                self.stats.refine_batches += 1
            self._refine.submit(
                lambda: self._run_refine(srv, cold_reqs, deadline)
            )
        if hot_i.size:
            res, certs = srv.window(los[hot_i], his[hot_i],
                                    return_certs=True, deadline=deadline)
            self._finish_batch([reqs[i] for i in hot_i], res, certs, False)

    def _run_refine(self, srv, reqs, deadline) -> None:
        """Refine-lane task: host cold path for one cold sub-batch."""
        live = []
        for r in reqs:
            if r.done:
                continue  # a retried dispatch re-submitted this sub-batch
            if r.deadline is not None and self.clock() >= r.deadline:
                self._finish_dropped(
                    r, "timeout", "deadline expired before refinement",
                    stat="timed_out",
                )
            else:
                live.append(r)
        if not live:
            return
        try:
            los = np.stack([r.payload[0] for r in live])
            his = np.stack([r.payload[1] for r in live])
            res, certs = srv.window(los, his, return_certs=True,
                                    deadline=deadline)
        except DeadlineExceeded:
            for r in live:
                self._finish_dropped(
                    r, "timeout", "deadline exceeded during refinement",
                    stat="timed_out",
                )
            return
        except (FaultError, RetryExhausted, ShardUnavailable) as e:
            for r in live:
                self._finish_dropped(r, "shed", f"refinement failed: {e}",
                                     stat="shed")
            return
        except Exception as e:
            self._fail(live, "refinement", e)
            return
        self._finish_batch(live, res, certs, False)

    def _finish_batch(self, reqs, res, certs, brown: bool) -> None:
        t = self.clock()
        with self._mu:
            # claim-or-skip under _mu, like _finish_dropped: the device
            # and refine lanes may both carry a request after a retried
            # dispatch, and only the first finisher may write its
            # terminal state
            for r, ids, cert in zip(reqs, res, certs):
                if r.done:
                    continue
                r.status = "ok"
                r.ids = np.asarray(ids)
                r.cert = cert
                r.brownout = brown
                r.t_done = t
                self.stats.completed += 1
                r._event.set()

    # -- real-time dispatcher -------------------------------------------------
    def start(self) -> "Frontend":
        """Spawn the dispatcher thread (real-time mode).  It owns every
        device dispatch: batches form on the shared clock and execute on
        this one thread, so the device never sees concurrent dispatches
        while refinement overlaps on its own lane."""
        if self._virtual:
            raise RuntimeError(
                "start() is for the real clock; under a VirtualClock "
                "drive pump()/drain() explicitly"
            )
        if self._dispatcher is not None:
            raise RuntimeError("frontend already started")
        self._dispatcher = threading.Thread(
            target=self._loop, name="frontend-dispatch", daemon=True
        )
        self._dispatcher.start()
        return self

    def _loop(self) -> None:
        while True:
            with self._mu:
                while True:
                    if self._stopping:
                        break
                    now = self.clock()
                    if self._due_lanes(now, False):
                        break
                    nxt = self._next_due(now)
                    self._mu.wait(
                        None if nxt is None else max(nxt - now, 0.0)
                    )
                if self._stopping and self._depth == 0:
                    return
            self.pump(flush=self._stopping)

    def stop(self, drain: bool = True) -> None:
        """Stop serving.  ``drain=True`` flushes queued requests through
        dispatch first; either way every still-queued request reaches a
        terminal state before return.  Then it raises the first error
        that was not an injected fault."""
        with self._mu:
            self._stopping = True
            self._mu.notify_all()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=30.0)
            self._dispatcher = None
        try:
            if drain:
                self.drain()
            else:
                with self._mu:
                    leftovers = [r for q in self._queues.values() for r in q]
                    self._queues.clear()
                    self._depth = 0
                for r in leftovers:
                    self._finish_dropped(r, "shed", "frontend stopped",
                                         stat="shed")
        finally:
            self._executor.stop()
            self._refine.stop()
        self._raise_errors()
