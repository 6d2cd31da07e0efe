"""Serving engine of the PyTorch port: batched window and k-NN serving
over a ``NodeTable`` (``DeviceQueryServer``, with AMBI's adaptive mode),
and batched k-NN retrieval over the balanced grid index
(``RetrievalServer``).

The port of ``DeviceQueryStats``, ``DeviceQueryServer``,
``RetrievalServer`` and ``RetrievalStats`` from the JAX package's
``repro/serve/engine.py``.

``DeviceQueryServer`` exports the table to the card once and serves every
microbatch through the device engine (``core/queries_torch.py``); in
``adaptive=True`` mode (boot via ``from_ambi``) it serves a partially
refined AMBI table: hot queries from the device's partial export, cold
ones from the host AMBI engine, whose grafts reach the card through
``DeviceTable.apply_delta``.  The resilience plane (retries, deadlines,
a breaker for the one device, fault injection) is the reference's.

``RetrievalServer`` in ``adaptive=True`` mode keeps "hot" only the
leaves that the live query stream touches (the device analogue of the
paper's buffer retention), in an LRU of ``hot_capacity`` leaves, with hit
statistics for the workload-adaptation benchmark.

Both live on ``device`` (``cuda`` unless the caller names another;
raises without a card).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from ..analysis import runtime as _san
from ..core import grid_index
from ..core.distributed_torch import CompletenessCertificate, ShardUnavailable
from ..core.geometry import boxes_intersect_windows, boxes_mindist_sq
from ..core.nodetable import NodeTable
from ..core.queries_torch import (
    DeviceTable,
    UploadStats,
    knn_query_batch_torch,
    resolve_device,
    window_query_batch_torch,
)
from ..kernels import ops as kops
from .faults import FaultError
from .resilience import (
    CircuitBreaker,
    Deadline,
    DeadlineExceeded,
    RetryExhausted,
    RetryPolicy,
    TableLock,
)


@dataclasses.dataclass
class RetrievalStats:
    queries: int = 0
    hot_hits: int = 0
    cold_misses: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hot_hits + self.cold_misses
        return self.hot_hits / total if total else 0.0


class RetrievalServer:
    """Batched exact k-NN over a ``GridIndex`` (CUDA distance kernels).

    Two boot paths: build a balanced index from raw points on the device
    (``__init__``), or bridge a bulk-loaded ``NodeTable`` snapshot straight
    into the grid layout (``from_snapshot``): no rebuild, no re-sort.
    """

    def __init__(self, points: np.ndarray, levels: int, *,
                 adaptive: bool = False, hot_capacity: int = 64, device=None):
        padded, ids = grid_index.pad_points(np.asarray(points).astype(np.float32),
                                            levels)
        self.index = grid_index.build(padded, levels, ids.astype(np.int32),
                                      device=resolve_device(device))
        self._routed = True  # built indexes carry split tables for route()
        self._init_serving(levels, adaptive, hot_capacity)

    @classmethod
    def from_snapshot(cls, path, *, adaptive: bool = False,
                      hot_capacity: int = 64, device=None) -> "RetrievalServer":
        """Boot from a ``NodeTable.save`` snapshot (``.npz`` with points;
        the JAX package's snapshots load too).

        The snapshot's leaf-contiguous layout maps directly onto the grid
        via ``NodeTable.to_grid_index``; adaptive residency locates leaves
        with ``nearest_leaf`` because a bridged FMBI tree has no balanced
        split tables.
        """
        dev = resolve_device(device)
        table, _meta, points = NodeTable.load(path)
        if points is None:
            raise ValueError("snapshot was saved without points")
        self = cls.__new__(cls)
        self.index = table.to_grid_index(np.asarray(points)).to(dev)
        self._routed = False
        self._init_serving(self.index.levels, adaptive, hot_capacity)
        return self

    def _init_serving(self, levels: int, adaptive: bool,
                      hot_capacity: int) -> None:
        self.levels = levels
        self.adaptive = adaptive
        # leaf -> last-touch tick, insertion-ordered: recency order IS the
        # dict order, so eviction is popitem(last=False)
        self.hot: OrderedDict[int, int] = OrderedDict()
        self.hot_capacity = hot_capacity
        self.tick = 0
        self.stats = RetrievalStats()

    def _queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(np.asarray(queries, np.float32)).to(self.index.device)

    def knn(self, queries: np.ndarray, k: int, n_candidate_leaves: int = 8):
        """``(row_ids, dists_sq, exact)`` as NumPy arrays; see
        ``grid_index.knn``."""
        q = self._queries(queries)
        rows, d2, exact = grid_index.knn(self.index, q, k,
                                         n_candidate_leaves=n_candidate_leaves)
        if self.adaptive:
            locate = grid_index.route if self._routed else grid_index.nearest_leaf
            for leaf in locate(self.index, q).cpu().tolist():
                self.tick += 1
                if leaf in self.hot:
                    self.stats.hot_hits += 1
                    self.hot.move_to_end(leaf)
                else:
                    self.stats.cold_misses += 1
                self.hot[leaf] = self.tick
                if len(self.hot) > self.hot_capacity:
                    self.hot.popitem(last=False)  # least recent first
            self.stats.queries += len(q)
        return rows.cpu().numpy(), d2.cpu().numpy(), exact.cpu().numpy()

    def knn_kernel(self, queries: np.ndarray, k: int):
        """Brute force over every slot of the grid (distance rows +
        top-k).  Returns ``(idx, dists_sq)``, where ``idx`` indexes
        ``index.points_sorted`` as in the JAX package (map it through
        ``index.row_ids`` for dataset rows)."""
        idx, d2 = kops.knn_topk(
            self._queries(queries), self.index.points_sorted, k,
            valid=(self.index.row_ids >= 0).to(torch.int32),
        )
        return idx.cpu().numpy(), d2.cpu().numpy()


@dataclasses.dataclass
class DeviceQueryStats:
    queries: int = 0
    microbatches: int = 0
    shards: int = 1
    hot_queries: int = 0       # answered entirely on the device
    cold_queries: int = 0      # reached unindexed space -> host + refine
    grafts: int = 0            # unrefined rows refined by the serving loop
    delta_refreshes: int = 0   # DeviceTable.apply_delta swaps
    compactions: int = 0       # NodeTable.compact vacuums
    retries: int = 0           # dispatch/refine attempts beyond the first
    host_fallbacks: int = 0    # device outage answered by the host engine
    degraded_queries: int = 0  # answers returned with an incomplete cert


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md {item})"
    )


class DeviceQueryServer:
    """Batched window/k-NN serving over a ``NodeTable`` through the device
    engine (``core/queries_torch.py``) on one card.

    Boots from a built index (or its ``.npz`` snapshot) by exporting the
    flat table to ``device`` once (``cuda`` unless the caller passes
    ``device="cpu"``; raises without a card); every microbatch afterwards
    runs on the device.  Incoming traffic is split into ``microbatch``-
    sized chunks.  Exactness matches the NumPy engine (see the
    queries_torch parity contract); the simulated LRU I/O accounting stays
    with the host engine.

    ``adaptive=True`` (boot via :meth:`from_ambi`) serves an AMBI table
    that may be arbitrarily unrefined, down to the single-unrefined-root
    state, where the device holds nothing but the root's cold box:

      * the table is exported *partially*: unrefined rows ride along as
        cold boxes the frontier surfaces as a mask;
      * a query that never reaches cold space is answered entirely from
        the device (no simulated I/O, the hot path);
      * a cold query is answered by the host AMBI engine, whose refiner
        charges the paper's I/O and grafts the touched subspaces;
      * after each microbatch the grafts are pushed to the device
        incrementally: ``DeviceTable.apply_delta`` uploads only the new
        leaf blocks into a double-buffered swap, and ``NodeTable.compact``
        vacuums dead perm segments once grafting has bloated the host
        table past ``compact_slack``.

    The resilience plane treats the one device as shard 0: each dispatch
    passes the ``shard_dispatch`` fault point under ``retry`` and a
    circuit breaker; an outage past them raises, degrades to an
    incomplete certificate (``return_certs=True``), or, on an adaptive
    server, is answered exactly by the host engine.

    Only an injected :class:`FaultError` is retried or turned into an
    outage: any other error of a dispatch or an upload (a kernel that
    fails to build or launch, a CUDA error) propagates to the caller.

    ``shards > 1`` (the sharded engine) is not ported yet and raises
    ``NotImplementedError``.
    """

    def __init__(self, table, points: np.ndarray, *,
                 microbatch: int = 64, compressed: bool = False,
                 shards: int | None = None, adaptive: bool = False,
                 ambi=None, compact_slack: float = 0.5,
                 fault_plan=None, retry=None, deadline_s: float | None = None,
                 breaker_threshold: int = 3, breaker_cooldown_s: float = 30.0,
                 clock=None, device=None):
        if shards is not None and shards > 1:
            raise _not_ported("sharded serving (shards > 1)", "A.5")
        if adaptive:
            if ambi is None:
                raise ValueError(
                    "adaptive serving needs the host AMBI engine — boot "
                    "with DeviceQueryServer.from_ambi(ambi)"
                )
            table, points = ambi.table, ambi.points
        points = np.asarray(points)
        self.device = resolve_device(device)
        # resilience plane: per-server policies, injectable for tests
        self.fault_plan = fault_plan
        self.retry = retry if retry is not None else RetryPolicy()
        self.deadline_s = deadline_s
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.clock = clock  # None -> time.monotonic inside the primitives
        self.breakers: dict = {}
        # table RW-lock: device dispatches and cold-mask computations read
        # the host table; adaptive refinement (graft/apply_delta/compact)
        # and repair write it.  Single-threaded callers pay two
        # uncontended acquisitions.
        self.table_lock = TableLock()
        # per-server upload accounting
        self.upload_stats = UploadStats()
        if adaptive and fault_plan is not None:
            ambi.store.fault_hook = fault_plan.pagestore_hook()
        self.dev = DeviceTable.from_table(
            table, points, partial=adaptive, stats=self.upload_stats,
            compressed=compressed, device=self.device,
        )
        self.table = table
        self.adaptive = adaptive
        self.ambi = ambi
        self.points = points  # the served dataset
        self.dim = int(points.shape[1])
        # compaction epoch: bumped under the writer lock whenever compact()
        # moves rows, so a lock-split reader can detect that its captured
        # row indices went stale before it re-enters as a writer
        self._table_version = 0
        self.compact_slack = float(compact_slack)
        self.microbatch = int(microbatch)
        self.compressed = bool(compressed)
        self.stats = DeviceQueryStats()
        # REPRO_SANITIZE: bind the shared mutable table to the writer lock
        # that guards it.  Binding is the LAST construction step:
        # everything above runs unpublished and single-threaded;
        # everything after must hold the lock.
        if ambi is not None:
            _san.bind(ambi.table, self.table_lock)

    @classmethod
    def from_index(cls, index, **kw) -> "DeviceQueryServer":
        """From a built ``core.fmbi.Index`` (or AMBI's ``.index``)."""
        return cls(index.table, index.points, **kw)

    @classmethod
    def from_ambi(cls, ambi, **kw) -> "DeviceQueryServer":
        """Adaptive serving over a host AMBI engine (any refinement state,
        including the freshly constructed single-unrefined-root table)."""
        return cls(ambi.table, ambi.points, adaptive=True, ambi=ambi, **kw)

    @classmethod
    def from_snapshot(cls, path, **kw) -> "DeviceQueryServer":
        """From a ``NodeTable.save``/``Index.save`` snapshot with points
        (the JAX package's snapshots load too)."""
        table, _meta, points = NodeTable.load(path)
        if points is None:
            raise ValueError("snapshot was saved without points")
        return cls(table, points, **kw)

    def _chunks(self, n: int):
        for start in range(0, n, self.microbatch):
            yield start, min(start + self.microbatch, n)

    # -- resilience plane ----------------------------------------------------
    def _breaker(self, s: int):
        br = self.breakers.get(s)
        if br is None:
            kw = {} if self.clock is None else {"clock": self.clock}
            # setdefault, not assignment: two lanes creating the breaker
            # concurrently must converge on ONE instance, or failure
            # counts split across copies and the breaker never opens
            br = self.breakers.setdefault(s, CircuitBreaker(
                self.breaker_threshold, self.breaker_cooldown_s, **kw
            ))
        return br

    def _deadline(self):
        kw = {} if self.clock is None else {"clock": self.clock}
        return Deadline(self.deadline_s, **kw)

    def _count_retry(self, attempt, exc) -> None:
        self.stats.retries += 1

    def _shard_runner(self, deadline):
        """The resilience hook every device dispatch goes through (the one
        device is shard 0): breaker fail-fast, then bounded retries (each
        attempt passing the shard's fault point), then breaker
        accounting.  A shard that exhausts its retries surfaces as
        :class:`ShardUnavailable`, the degraded-mode signal."""

        def run(s: int, thunk):
            br = self._breaker(s)
            if not br.allow():
                raise ShardUnavailable(s, "circuit open")

            def attempt():
                if self.fault_plan is not None:
                    self.fault_plan.fire("shard_dispatch", shard=int(s))
                return thunk()

            try:
                res = self.retry.call(
                    attempt, retry_on=(FaultError,), deadline=deadline,
                    no_retry=(DeadlineExceeded, ShardUnavailable),
                    on_retry=self._count_retry, call_key=("shard", int(s)),
                )
            except (DeadlineExceeded, ShardUnavailable):
                raise
            except RetryExhausted as e:
                br.record_failure()
                raise ShardUnavailable(s, str(e)) from e
            br.record_success()
            return res

        return run

    def repair(self, shard_ids=None) -> list[int]:
        """Re-export the device table from the host ``NodeTable`` and close
        the breakers; with no argument, repairs when a breaker is not
        closed.  Returns the repaired shard ids (``[0]`` or ``[]``)."""
        if shard_ids is None:
            shard_ids = [
                s for s, br in self.breakers.items() if br.state != "closed"
            ]
        shard_ids = sorted(int(s) for s in shard_ids)
        if not shard_ids:
            return []
        with self.table_lock.write():
            t = self.ambi.table if self.adaptive else self.table
            self.dev = DeviceTable.from_table(
                t, self.points, partial=self.adaptive,
                stats=self.upload_stats, compressed=self.compressed,
                device=self.device,
            )
        for s in shard_ids:
            self._breaker(s).reset()
        return shard_ids

    def _root_cert(self):
        """Degraded certificate for a whole-table outage: the entire root
        MBB is unanswered."""
        t = self.ambi.table if self.adaptive else self.table
        return CompletenessCertificate(
            complete=False, certified_exact=False, missing_shards=(0,),
            missing_lo=np.asarray(t.mbb_lo[0], dtype=np.float32)[None],
            missing_hi=np.asarray(t.mbb_hi[0], dtype=np.float32)[None],
        )

    # -- input validation ----------------------------------------------------
    def _validate_batch(self, arr, name: str) -> np.ndarray:
        """API-boundary validation: precise errors here instead of cryptic
        failures deep in the engine."""
        a = np.asarray(arr)
        if a.dtype == object or not np.issubdtype(a.dtype, np.number):
            raise ValueError(
                f"{name}: expected a numeric array, got dtype {a.dtype}"
            )
        if np.issubdtype(a.dtype, np.complexfloating):
            raise ValueError(f"{name}: complex coordinates are not supported")
        a = np.atleast_2d(a.astype(np.float64, copy=False))
        if a.ndim != 2 or a.shape[1] != self.dim:
            raise ValueError(
                f"{name}: expected shape (Q, {self.dim}) to match the "
                f"{self.dim}-dimensional dataset, got {np.asarray(arr).shape}"
            )
        if np.isnan(a).any():
            bad = int(np.flatnonzero(np.isnan(a).any(axis=1))[0])
            raise ValueError(f"{name}: query {bad} contains NaN coordinates")
        return a

    def window(self, los: np.ndarray, his: np.ndarray, *,
               return_certs: bool = False, deadline=None) -> list[np.ndarray]:
        """Per-query dataset row ids inside each [lo, hi] box.

        ``return_certs=True`` opts into degraded serving: the return is
        ``(results, certs)`` and a device outage (breaker open / retries
        exhausted) yields empty results whose ``CompletenessCertificate``
        names the root box as unanswered instead of raising.  Adaptive
        serving answers outages host-side, so its certificates are always
        intact.

        ``deadline`` overrides the server's own per-batch budget.
        """
        los = self._validate_batch(los, "los")
        his = self._validate_batch(his, "his")
        if los.shape != his.shape:
            raise ValueError(
                f"los/his shape mismatch: {los.shape} vs {his.shape}"
            )
        if deadline is None:
            deadline = self._deadline()
        out: list[np.ndarray] = []
        certs: list = []
        for a, b in self._chunks(los.shape[0]):
            runner = self._shard_runner(deadline)
            if self.adaptive:
                out.extend(self._window_adaptive(los[a:b], his[a:b], deadline))
                certs.extend(
                    CompletenessCertificate.intact() for _ in range(b - a)
                )
            else:
                try:
                    with self.table_lock.read():
                        out.extend(runner(0, lambda a=a, b=b: (
                            window_query_batch_torch(
                                self.dev, los[a:b], his[a:b],
                            )
                        )))
                    certs.extend(
                        CompletenessCertificate.intact()
                        for _ in range(b - a)
                    )
                except ShardUnavailable:
                    if not return_certs:
                        raise
                    out.extend(
                        np.zeros(0, dtype=np.int64) for _ in range(b - a)
                    )
                    certs.extend(self._root_cert() for _ in range(b - a))
            self.stats.microbatches += 1
        self.stats.queries += los.shape[0]
        if return_certs:
            self.stats.degraded_queries += sum(
                1 for c in certs if not c.complete
            )
            return out, certs
        return out

    def knn(self, qs: np.ndarray, k: int, *,
            return_certs: bool = False, deadline=None,
            max_rounds: int | None = None) -> list[np.ndarray]:
        """Per-query ascending-distance row ids (length min(k, n)).

        Degraded mode mirrors :meth:`window`.  ``max_rounds`` caps the
        device engine's budget-escalation rounds (the brownout tier); a
        capped query returns its best-effort answer with
        ``certified_exact=False`` on its certificate.  The adaptive host
        path keeps its own exactness machinery and ignores the cap.
        """
        qs = self._validate_batch(qs, "qs")
        if not isinstance(k, (int, np.integer)) or int(k) < 1:
            raise ValueError(f"k must be a positive integer, got {k!r}")
        k = int(k)
        if deadline is None:
            deadline = self._deadline()
        out: list[np.ndarray] = []
        certs: list = []
        for a, b in self._chunks(qs.shape[0]):
            runner = self._shard_runner(deadline)
            if self.adaptive:
                out.extend(self._knn_adaptive(qs[a:b], k, deadline))
                certs.extend(
                    CompletenessCertificate.intact() for _ in range(b - a)
                )
            else:
                try:
                    with self.table_lock.read():
                        res, exact = runner(0, lambda a=a, b=b: (
                            knn_query_batch_torch(
                                self.dev, qs[a:b], k,
                                max_rounds=max_rounds, return_exact=True,
                            )
                        ))
                    out.extend(res)
                    certs.extend(
                        CompletenessCertificate.intact() if bool(e)
                        else CompletenessCertificate(
                            complete=True, certified_exact=False
                        )
                        for e in exact
                    )
                except ShardUnavailable:
                    if not return_certs:
                        raise
                    out.extend(
                        np.zeros(0, dtype=np.int64) for _ in range(b - a)
                    )
                    certs.extend(self._root_cert() for _ in range(b - a))
            self.stats.microbatches += 1
        self.stats.queries += qs.shape[0]
        if return_certs:
            self.stats.degraded_queries += sum(
                1 for c in certs if not c.complete
            )
            return out, certs
        return out

    def cold_window_mask(self, los: np.ndarray, his: np.ndarray) -> np.ndarray:
        """Which window queries reach unrefined (cold) space: the cheap
        host-side test that splits a microbatch into a device-lane hot
        part and a refine-lane cold part *before* dispatch.  Hit sets are
        downward-closed, so reaching an unrefined row equals intersecting
        its MBB.  Non-adaptive servers have no cold space: all-False."""
        los = np.atleast_2d(np.asarray(los, dtype=np.float64))
        his = np.atleast_2d(np.asarray(his, dtype=np.float64))
        if not self.adaptive:
            return np.zeros(los.shape[0], dtype=bool)
        with self.table_lock.read():
            return self._cold_mask_unlocked(los, his)

    # -- brownout tier: device-only answers, no host refinement --------------
    def _cold_boxes_cert(self, lo, hi):
        """Certificate for a cold query answered device-only: the unrefined
        subspaces intersecting the window are the unanswered region."""
        t = self.ambi.table
        unref = np.flatnonzero(t.unrefined)
        if len(unref):
            hit = boxes_intersect_windows(
                t.mbb_lo[unref], t.mbb_hi[unref], lo[None], hi[None]
            )[0]
            unref = unref[hit]
        if not len(unref):
            return CompletenessCertificate.intact()
        return CompletenessCertificate(
            complete=False, certified_exact=False, missing_shards=(),
            missing_lo=np.asarray(t.mbb_lo[unref], dtype=np.float32),
            missing_hi=np.asarray(t.mbb_hi[unref], dtype=np.float32),
        )

    def window_hot(self, los: np.ndarray, his: np.ndarray, *,
                   deadline=None):
        """Brownout-tier window serving: answer from the device's refined
        subset only — no host refinement, no grafting, no cold-path I/O.
        Returns ``(results, certs)``; a query reaching cold space comes
        back *partial* (its refined-subset hits) with the unrefined
        subspaces it touches listed as the certificate's missing boxes.
        Only meaningful on an adaptive server; a fully refined table makes
        this identical to :meth:`window`."""
        if not self.adaptive:
            return self.window(los, his, return_certs=True,
                               deadline=deadline)
        los = self._validate_batch(los, "los")
        his = self._validate_batch(his, "his")
        if deadline is None:
            deadline = self._deadline()
        out: list[np.ndarray] = []
        certs: list = []
        for a, b in self._chunks(los.shape[0]):
            runner = self._shard_runner(deadline)
            with self.table_lock.read():
                cold_q = np.asarray(
                    self._cold_mask_unlocked(los[a:b], his[a:b])
                )
                res, cold = runner(0, lambda a=a, b=b: (
                    window_query_batch_torch(
                        self.dev, los[a:b], his[a:b], return_cold=True,
                    )
                ))
                res = list(res)
                cold_q = cold_q | np.asarray(cold).any(axis=1)
                for i in range(b - a):
                    certs.append(
                        self._cold_boxes_cert(los[a + i], his[a + i])
                        if cold_q[i]
                        else CompletenessCertificate.intact()
                    )
            out.extend(res)
            self.stats.microbatches += 1
            self.stats.hot_queries += int((~cold_q).sum())
            self.stats.cold_queries += int(cold_q.sum())
        self.stats.queries += los.shape[0]
        self.stats.degraded_queries += sum(1 for c in certs if not c.complete)
        return out, certs

    def knn_hot(self, qs: np.ndarray, k: int, *, deadline=None,
                max_rounds: int | None = None):
        """Brownout-tier k-NN: device-only, escalation capped, no host
        refinement.  Returns ``(results, certs)``: a query whose answer
        a cold box could still beat (or whose escalation was capped)
        carries ``certified_exact=False``."""
        if not self.adaptive:
            return self.knn(qs, k, return_certs=True, deadline=deadline,
                            max_rounds=max_rounds)
        qs = self._validate_batch(qs, "qs")
        k = int(k)
        if deadline is None:
            deadline = self._deadline()
        out: list[np.ndarray] = []
        certs: list = []
        for a, b in self._chunks(qs.shape[0]):
            runner = self._shard_runner(deadline)
            with self.table_lock.read():
                t = self.ambi.table
                res, exact = runner(0, lambda a=a, b=b: (
                    knn_query_batch_torch(
                        self.dev, qs[a:b], k,
                        max_rounds=max_rounds, return_exact=True,
                    )
                ))
                res = list(res)
                cold_q = self._knn_cold_mask(qs[a:b], res, k)
                unref = np.flatnonzero(t.unrefined)
                for i in range(b - a):
                    if not cold_q[i] and exact[i]:
                        certs.append(CompletenessCertificate.intact())
                    else:
                        certs.append(CompletenessCertificate(
                            complete=not cold_q[i],
                            certified_exact=False,
                            missing_shards=(),
                            missing_lo=np.asarray(
                                t.mbb_lo[unref], dtype=np.float32),
                            missing_hi=np.asarray(
                                t.mbb_hi[unref], dtype=np.float32),
                        ))
            out.extend(res)
            self.stats.microbatches += 1
            self.stats.hot_queries += int((~cold_q).sum())
            self.stats.cold_queries += int(cold_q.sum())
        self.stats.queries += qs.shape[0]
        self.stats.degraded_queries += sum(1 for c in certs if not c.complete)
        return out, certs

    def _cold_mask_unlocked(self, los, his) -> np.ndarray:
        """`cold_window_mask` body without the lock (callers hold read)."""
        t = self.ambi.table
        unref = np.flatnonzero(t.unrefined)
        if not len(unref):
            return np.zeros(np.atleast_2d(los).shape[0], dtype=bool)
        return boxes_intersect_windows(
            t.mbb_lo[unref], t.mbb_hi[unref],
            np.asarray(los, dtype=np.float64),
            np.asarray(his, dtype=np.float64),
        ).any(axis=1)

    # -- adaptive serving loop ----------------------------------------------
    # The host AMBI engine is authoritative over the full dataset, so the
    # adaptive server degrades *gracefully* under device outages: a failed
    # dispatch reroutes the affected queries down the (exact) host cold
    # path instead of returning partial answers — certificates stay intact.
    def _host_window(self, lo, hi) -> np.ndarray:  # analysis: caller-holds-write
        """Cold-path window: host-answer (+ refine) under retry.  Faults
        fire at entry, before any host mutation, so a retried attempt
        re-runs the op from scratch."""

        def attempt():
            if self.fault_plan is not None:
                self.fault_plan.fire("host_refine", op="window")
            return self.ambi.window(lo, hi)

        ids, _ = self.retry.call(
            attempt, retry_on=(FaultError,), on_retry=self._count_retry,
            call_key="host_refine",
        )
        return ids

    def _host_knn(self, q, k: int) -> np.ndarray:  # analysis: caller-holds-write
        def attempt():
            if self.fault_plan is not None:
                self.fault_plan.fire("host_refine", op="knn")
            return self.ambi.knn(q, k)

        ids, _ = self.retry.call(
            attempt, retry_on=(FaultError,), on_retry=self._count_retry,
            call_key="host_refine",
        )
        return ids

    def _window_adaptive(self, los, his, deadline=None) -> list[np.ndarray]:
        """One microbatch: device answers for hot queries, host answers
        (+ refinement + device refresh) for queries reaching cold space."""
        runner = self._shard_runner(deadline)
        with self.table_lock.read():
            t = self.ambi.table
            unref = np.flatnonzero(t.unrefined)
            version = self._table_version
            try:
                res, cold = runner(0, lambda: window_query_batch_torch(
                    self.dev, los, his, return_cold=True,
                ))
                out = list(res)
                cold_q = cold.any(axis=1)
            except ShardUnavailable:
                # whole-device outage: host serves the full microbatch
                out = [None] * los.shape[0]
                cold_q = np.ones(los.shape[0], dtype=bool)
                self.stats.host_fallbacks += los.shape[0]
        if cold_q.any():
            with self.table_lock.write():
                if self._table_version != version:
                    # a writer compacted between our read and write
                    # sections: the captured row indices are stale
                    unref = np.flatnonzero(t.unrefined)
                for i in np.flatnonzero(cold_q):
                    out[i] = self._host_window(los[i], his[i])
                self._after_refinement(unref)  # pre-serving unrefined rows
        self.stats.hot_queries += int((~cold_q).sum())
        self.stats.cold_queries += int(cold_q.sum())
        return out

    def _knn_adaptive(self, qs, k: int, deadline=None) -> list[np.ndarray]:
        runner = self._shard_runner(deadline)
        with self.table_lock.read():
            t = self.ambi.table
            degraded = np.zeros(qs.shape[0], dtype=bool)
            try:
                res = list(runner(0, lambda: knn_query_batch_torch(
                    self.dev, qs, k
                )))
            except ShardUnavailable:
                res = [np.zeros(0, dtype=np.int64)] * qs.shape[0]
                degraded[:] = True
                self.stats.host_fallbacks += qs.shape[0]
            out = list(res)
            cold_q = self._knn_cold_mask(qs, res, k) | degraded
            before_unref = np.flatnonzero(t.unrefined)
            version = self._table_version
        if cold_q.any():
            with self.table_lock.write():
                if self._table_version != version:
                    before_unref = np.flatnonzero(t.unrefined)
                for i in np.flatnonzero(cold_q):
                    out[i] = self._host_knn(qs[i], k)
                self._after_refinement(before_unref)
        self.stats.hot_queries += int((~cold_q).sum())
        self.stats.cold_queries += int(cold_q.sum())
        return out

    def _knn_cold_mask(self, qs, res, k: int) -> np.ndarray:
        """Which queries the device answer cannot certify: a cold box
        could hold a closer neighbor (mindist within the k-th distance,
        both exact float64 over the host data — ``<=`` keeps boundary
        ties host-side, matching what the host's own best-first refinement
        would expand), or the refined subset is short of k."""
        t = self.ambi.table
        qs = np.asarray(qs, dtype=np.float64)
        cold = np.zeros(qs.shape[0], dtype=bool)
        unref = np.flatnonzero(t.unrefined)
        want = min(k, len(self.points))
        if not len(unref):
            return cold
        minds = boxes_mindist_sq(t.mbb_lo[unref], t.mbb_hi[unref], qs)
        for i, ids in enumerate(res):
            if len(ids) < want:
                cold[i] = True
                continue
            kth = float(
                np.max(np.sum((self.points[ids] - qs[i]) ** 2, axis=1))
            )
            cold[i] = bool(minds[i].min() <= kth)
        return cold

    def _after_refinement(self, before_unref: np.ndarray) -> None:  # analysis: caller-holds-write
        """Push the microbatch's grafts to the device with one incremental
        delta, then vacuum the host table if grafting bloated it.

        The upload is retried under the ``apply_delta`` fault point (fired
        at entry: an injected upload fault never half-applies, since the
        swap is double-buffered and the old export serves until the new
        one lands).  An upload that exhausts its retries leaves the device
        stale but the *host* current; the next cold answer/fallback is
        still exact, and the refresh is re-attempted after the next graft.
        """
        t = self.ambi.table
        grafted = before_unref[~t.unrefined[before_unref]]
        if len(grafted) == 0:
            return
        self.stats.grafts += len(grafted)

        def upload():
            if self.fault_plan is not None:
                self.fault_plan.fire("apply_delta")
            self.dev = self.dev.apply_delta(t, self.points)  # swap
            self.stats.delta_refreshes += 1

        try:
            self.retry.call(
                upload, retry_on=(FaultError,), on_retry=self._count_retry,
                call_key="apply_delta",
            )
        except RetryExhausted:
            pass  # device stale, host authoritative; retried next graft
        self._maybe_compact()

    def _maybe_compact(self) -> None:  # analysis: caller-holds-write
        """Vacuum the host table once grafting bloated it, rebasing the
        device table's row maps through the returned remap."""
        t = self.ambi.table
        if t.n_perm > (1.0 + self.compact_slack) * len(self.points):
            # the compact() row remap and the device rebase must be one
            # atomic writer section: a concurrent apply_delta swap (or
            # reader capturing row indices) between them would observe a
            # half-rebased slot map.  Callers enter through the adaptive
            # write sections; this pins the invariant for new call sites.
            assert self.table_lock.held_write(), (
                "_maybe_compact requires the TableLock writer section"
            )
            remap = t.compact()
            self.dev.remap_rows(remap)
            self._table_version += 1
            self.stats.compactions += 1
