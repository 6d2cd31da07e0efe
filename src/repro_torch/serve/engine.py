"""Serving engine of the PyTorch port: greedy generation over the dense
LM (``LMServer``), batched window and k-NN serving over a ``NodeTable``
(``DeviceQueryServer``, with AMBI's adaptive mode), and batched k-NN
retrieval over the balanced grid index (``RetrievalServer``).

The port of ``LMServer``, ``DeviceQueryStats``, ``DeviceQueryServer``,
``RetrievalServer`` and ``RetrievalStats`` from the JAX package's
``repro/serve/engine.py``.

``LMServer`` prefills the prompt batch once into caches allocated at
their final size (full-attention layers at ``cache_len``, local layers as
rings of ``min(local_window, cache_len)`` slots) and then decodes one
token per step on the model's device.  The reference grows its caches
after the prefill instead, and misses a remainder local layer's ring
(ROADMAP C.8); that fault is not copied.

``DeviceQueryServer`` exports the table to the card once and serves every
microbatch through the device engine (``core/queries_torch.py``); in
``adaptive=True`` mode (boot via ``from_ambi``) it serves a partially
refined AMBI table: hot queries from the device's partial export, cold
ones from the host AMBI engine, whose grafts reach the card through
``DeviceTable.apply_delta``.  ``from_streaming`` serves a live
``StreamingIndex`` (``insert``/``delete``, its tiers mirrored on the card
and shipped as deltas), and an adaptive server grows a streaming overlay
on its first insert.  With ``journal_path`` and ``snapshot_path`` every
cold op and every ingest op is journaled before it runs, ``checkpoint``
writes a snapshot barrier, and ``recover`` reboots a killed server from
the two.  The resilience plane (retries, deadlines, a breaker for the one
device, fault injection) is the reference's.

``RetrievalServer`` in ``adaptive=True`` mode keeps "hot" only the
leaves that the live query stream touches (the device analogue of the
paper's buffer retention), in an LRU of ``hot_capacity`` leaves, with hit
statistics for the workload-adaptation benchmark.

Both live on ``device`` (``cuda`` unless the caller names another;
raises without a card).
"""
from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict

import numpy as np
import torch

from ..analysis import runtime as _san
from ..core import grid_index
from ..core.ambi import AMBI
from ..core.distributed_torch import (
    CompletenessCertificate,
    ShardedDeviceTable,
    ShardUnavailable,
    knn_query_batch_sharded,
    window_query_batch_sharded,
)
from ..core.geometry import boxes_intersect_windows, boxes_mindist_sq
from ..core.nodetable import NodeTable
from ..core.queries_torch import (
    DeviceTable,
    UploadStats,
    knn_query_batch_torch,
    resolve_device,
    window_query_batch_torch,
)
from ..core.streaming import DeviceMirror, StreamingIndex
from ..kernels import ops as kops
from ..models.sharding import full
from .faults import FaultError
from .journal import GraftJournal, JournalError
from .resilience import (
    CircuitBreaker,
    Deadline,
    DeadlineExceeded,
    RetryExhausted,
    RetryPolicy,
    TableLock,
)


class LMServer:
    """Greedy generation over an :class:`~repro_torch.models.LM` of a
    token-only family (dense, MoE, RWKV6, the Mamba hybrid), on the
    model's device.  Every cache, attention or recurrent, is allocated at
    its final size by the prefill and nothing is grown afterwards.  Like
    the reference's, ``generate`` takes tokens only: an encoder-decoder or
    a VLM generates through ``LM.prefill``/``decode_step``."""

    def __init__(self, lm):
        self.lm = lm

    def generate(self, tokens, max_new: int, cache_len: int | None = None) -> np.ndarray:
        """Greedy generation for a ``(B, S)`` prompt batch: ``(B, max_new)``
        token ids.  ``cache_len`` (``S + max_new`` unless given) must hold
        every position a decode step writes, ``S + max_new - 1``."""
        cfg = self.lm.cfg
        if cfg.encoder_layers or cfg.frontend == "patch_stub":
            raise ValueError(f"{cfg.name} takes frames or patches: generate through "
                             f"LM.prefill and LM.decode_step")
        tokens = torch.as_tensor(tokens, device=self.lm.device)
        b, s = tokens.shape
        cache_len = cache_len or (s + max_new)
        if cache_len < s + max_new - 1:
            raise ValueError(f"cache_len {cache_len} < {s + max_new - 1} positions")
        lg, cache = self.lm.prefill(tokens, cache_len)
        out = [full(lg)[:, -1].argmax(dim=-1)]
        for t in range(max_new - 1):
            pos = torch.full((b,), s + t, dtype=torch.int64, device=self.lm.device)
            lg, cache = self.lm.decode_step(out[-1][:, None], cache, pos)
            out.append(full(lg)[:, 0].argmax(dim=-1))
        return torch.stack(out, dim=1).cpu().numpy()


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
    shard_refreshes: int = 0   # shards re-exported by ShardedDeviceTable
    delta_refreshes: int = 0   # DeviceTable.apply_delta swaps
    compactions: int = 0       # NodeTable.compact vacuums
    retries: int = 0           # dispatch/refine attempts beyond the first
    host_fallbacks: int = 0    # device outage answered by the host engine
    degraded_queries: int = 0  # answers returned with an incomplete cert
    journal_records: int = 0   # ops durably journaled before execution
    checkpoints: int = 0       # snapshot barriers written
    replayed_records: int = 0  # journal records replayed at recovery
    inserts: int = 0           # streamed points ingested
    deletes: int = 0           # ids tombstoned
    stream_syncs: int = 0      # structural device syncs (flush/merge shipped)
    stream_reshards: int = 0   # full re-shard fallbacks (should stay 0)


class StreamSyncError(RuntimeError):
    """An ``insert``/``delete`` was journaled and applied to the host
    stream, but shipping it to the device failed with an error that is not
    an injected fault.  The op is committed (``recover`` replays it), so
    the caller must not retry it.  ``ids`` are the ids it inserted or
    tombstoned, ``result`` what the call would have returned, and
    ``__cause__`` the device error."""

    def __init__(self, op: str, ids: np.ndarray, result, cause: BaseException):
        super().__init__(
            f"{op} of {len(ids)} ids was journaled and applied, but its "
            f"device sync failed ({cause!r}); do not retry it"
        )
        self.op = op
        self.ids = ids
        self.result = result


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

    ``shards=m`` serves through the *sharded* engine instead
    (``core/distributed_torch.py``): the table partitions into m
    per-shard exports behind a subspace-MBB router, all on ``device``;
    windows fan out only to qualified shards, and k-NN runs the two-round
    certified protocol — same results, distributed execution.

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
        leaf blocks into a double-buffered swap (sharded serving
        re-exports only the shards owning grafted subspaces), and
        ``NodeTable.compact`` vacuums dead perm segments once grafting
        has bloated the host table past ``compact_slack``.

    Streaming (boot via :meth:`from_streaming`): the host
    ``StreamingIndex`` is authoritative, the card serves a
    ``DeviceMirror`` of its tiers (rows are never removed, so every
    flush or merge ships as one ``apply_delta``), tombstones filter on the
    host and the not-yet-flushed delta rows are unioned in by brute force.
    A sharded streaming server rewrites its shard plans through each sync
    and re-exports only the shards whose content changed.

    The resilience plane (the one device is shard 0 unless sharded): each
    dispatch passes the ``shard_dispatch`` fault point under ``retry`` and
    a circuit breaker per shard; an outage past them raises, degrades to
    an incomplete certificate (``return_certs=True``), or, on an adaptive
    or streaming server, is answered exactly by the host engine.

    Only an injected :class:`FaultError` is retried or turned into an
    outage: any other error of a dispatch, an upload, a journal append or
    a snapshot (a kernel that fails to build or launch, a CUDA error, a
    failing disk) propagates to the caller.
    """

    # overlay construction defaults — shared by the live ingest path and
    # journal replay, which must build the identical structure
    OVERLAY_KW = dict(delta_threshold=2048, delta_index_every=256,
                      size_ratio=4)

    def __init__(self, table, points: np.ndarray, *,
                 microbatch: int = 64, compressed: bool = False,
                 shards: int | None = None, adaptive: bool = False,
                 ambi=None, stream=None, compact_slack: float = 0.5,
                 fault_plan=None, retry=None, deadline_s: float | None = None,
                 breaker_threshold: int = 3, breaker_cooldown_s: float = 30.0,
                 clock=None, journal_path=None, snapshot_path=None,
                 device=None):
        self.device = resolve_device(device)
        if adaptive:
            if ambi is None:
                raise ValueError(
                    "adaptive serving needs the host AMBI engine — boot "
                    "with DeviceQueryServer.from_ambi(ambi)"
                )
            if stream is not None:
                raise ValueError(
                    "an adaptive server grows its streaming overlay on "
                    "insert(); do not pass stream="
                )
            table, points = ambi.table, ambi.points
        self.stream = stream
        self.mirror = None
        if stream is not None:
            if not stream.tiers:
                raise ValueError(
                    "streaming serving boots from a stream with at least "
                    "one tier — seed it with points or insert past the "
                    "flush threshold first"
                )
            self.mirror = DeviceMirror(stream)
            table = self.mirror.table
            points = stream.points
        points = np.asarray(points)
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
        # and shard repair write it.  Single-threaded callers pay two
        # uncontended acquisitions.
        self.table_lock = TableLock()
        # per-server upload accounting
        self.upload_stats = UploadStats()
        if adaptive and fault_plan is not None:
            ambi.store.fault_hook = fault_plan.pagestore_hook()
        if shards is not None and shards > 1:
            self.sdev = ShardedDeviceTable.from_table(
                table, points, shards, partial=adaptive,
                stats=self.upload_stats, compressed=compressed,
                device=self.device,
            )
            self.dev = None
            n_shards = self.sdev.m
        else:
            self.dev = DeviceTable.from_table(
                table, points, partial=adaptive, stats=self.upload_stats,
                compressed=compressed, device=self.device,
            )
            self.sdev = None
            n_shards = 1
        self.table = table
        self.requested_shards = shards if shards is not None else 1
        self.adaptive = adaptive
        self.ambi = ambi
        self._points = points
        self.dim = int(points.shape[1])
        # compaction epoch: bumped under the writer lock whenever compact()
        # moves rows, so a lock-split reader can detect that its captured
        # row indices went stale before it re-enters as a writer
        self._table_version = 0
        # sharded streaming: shards a failed sync left behind, and the
        # summaries of syncs whose upload exhausted its retries (their plan
        # surgery never ran) — both re-enter the next sync
        self._stream_stale_shards: set[int] = set()
        self._stream_pending_syncs: list = []
        # single-device streaming: a tier upload exhausted its retries —
        # queries serve host-side (exact) until the next sync re-uploads
        self._stream_device_stale = False
        # streaming: an upload failed with an error that is not an
        # injected fault — it was raised to the inserter, and queries
        # raise too (never answered from the host) until a sync lands
        self._stream_device_error = None
        self.compact_slack = float(compact_slack)
        self.microbatch = int(microbatch)
        self.compressed = bool(compressed)
        self.stats = DeviceQueryStats(shards=n_shards)
        # durability plane (adaptive or streaming): write-ahead journal +
        # snapshot barriers; recovery = snapshot + replay (see recover())
        self.journal = None
        self.snapshot_path = None
        if journal_path is not None or snapshot_path is not None:
            if not adaptive and stream is None:
                raise ValueError(
                    "journaling/snapshots apply to adaptive or streaming "
                    "serving — a static table needs no recovery log"
                )
            if journal_path is None or snapshot_path is None:
                raise ValueError(
                    "durability needs BOTH journal_path and snapshot_path "
                    "(recovery replays the journal against the snapshot)"
                )
            self.snapshot_path = os.fspath(snapshot_path)
            if not self.snapshot_path.endswith(".npz"):
                self.snapshot_path += ".npz"
            self.journal = GraftJournal(journal_path, fault_plan=fault_plan)
            if not os.path.exists(self.snapshot_path):
                # boot barrier: capture the pre-serving state so a crash
                # before the first compaction is still recoverable
                self.checkpoint()
        # REPRO_SANITIZE: bind every shared mutable object the serving
        # layer publishes to the writer lock that guards it.  Binding is
        # the LAST construction step: everything above runs unpublished
        # and single-threaded; everything after must hold the lock.
        self._bind_sanitizer()

    def _bind_sanitizer(self) -> None:
        for obj in (self.stream,
                    self.mirror,
                    self.mirror.table if self.mirror is not None else None,
                    self.ambi.table if self.ambi is not None else None):
            if obj is not None:
                _san.bind(obj, self.table_lock)

    @property
    def points(self) -> np.ndarray:
        """The served dataset.  A streaming (non-adaptive) server's point
        buffer grows in place, so this is the stream's live view; adaptive
        servers keep the AMBI base here (the overlay carries its own)."""
        if self.stream is not None and not self.adaptive:
            return self.stream.points
        return self._points

    @classmethod
    def from_index(cls, index, **kw) -> "DeviceQueryServer":
        """From a built ``core.fmbi.Index`` (or AMBI's ``.index``)."""
        return cls(index.table, index.points, **kw)

    @classmethod
    def from_streaming(cls, stream, **kw) -> "DeviceQueryServer":
        """Live serving over a :class:`~repro_torch.core.streaming.StreamingIndex`:
        the server owns a :class:`DeviceMirror` of the stream's tiers,
        ``insert``/``delete`` route through the stream under the writer
        lock, and structural changes (flush/merge) ship to the device as
        deltas — never a full re-export after boot."""
        return cls(None, None, stream=stream, **kw)

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
        """The resilience hook every device dispatch goes through (the
        sharded protocols pass each shard's id; the one device of an
        unsharded server is shard 0): breaker fail-fast, then bounded
        retries (each attempt passing the shard's fault point), then
        breaker accounting.  A shard that exhausts its retries surfaces
        as :class:`ShardUnavailable`, the degraded-mode signal."""

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
        """Re-export failed shards from the host ``NodeTable`` (a
        streaming server's mirror) and close their breakers; with no
        argument, repairs every shard whose breaker is not closed.
        Returns the repaired shard ids."""
        if shard_ids is None:
            shard_ids = [
                s for s, br in self.breakers.items() if br.state != "closed"
            ]
        shard_ids = sorted(int(s) for s in shard_ids)
        if not shard_ids:
            return []
        with self.table_lock.write():
            if self.sdev is not None:
                self.sdev.refresh(shard_ids)
                self.stats.shard_refreshes += len(shard_ids)
                if (self._stream_device_error is not None
                        and not self._stream_pending_syncs
                        and self._stream_stale_shards <= set(shard_ids)):
                    # every shard a failed sync left behind is re-exported
                    self._stream_stale_shards = set()
                    self._stream_device_stale = False
                    self._stream_device_error = None
            else:
                t = self.ambi.table if self.adaptive else self.table
                self.dev = DeviceTable.from_table(
                    t, self.points, partial=self.adaptive,
                    stats=self.upload_stats, compressed=self.compressed,
                    device=self.device,
                )
                self._stream_device_stale = False
                self._stream_device_error = None
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
        ``(results, certs)`` and a shard outage (breaker open / retries
        exhausted) yields partial results whose
        ``CompletenessCertificate`` names the unanswered subspaces (the
        root box for an unsharded server) instead of raising.  Adaptive
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
                res = self._window_adaptive(los[a:b], his[a:b], deadline)
                if self.stream is not None:
                    res = self._merge_overlay_window(res, los[a:b], his[a:b])
                out.extend(res)
                certs.extend(
                    CompletenessCertificate.intact() for _ in range(b - a)
                )
            elif self.stream is not None:
                res = self._window_streaming(
                    los[a:b], his[a:b], runner, return_certs=return_certs,
                )
                if return_certs:
                    res, cs = res
                    certs.extend(cs)
                out.extend(res)
            elif self.sdev is not None:
                with self.table_lock.read():
                    res = window_query_batch_sharded(
                        self.sdev, los[a:b], his[a:b], runner=runner,
                        return_certs=return_certs,
                    )
                if return_certs:
                    res, cs = res
                    certs.extend(cs)
                out.extend(res)
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

        Degraded mode mirrors :meth:`window`; a k-NN certificate can be
        ``certified_exact`` even when shards were down (the pruning
        radius clears their subspaces — see the distributed protocol).

        ``max_rounds`` caps the device engine's budget-escalation rounds
        (the brownout tier); a capped query returns its best-effort answer
        with ``certified_exact=False`` on its certificate.  The cap
        applies to the single-table dispatch; the sharded two-round
        protocol and the adaptive host path keep their own exactness
        machinery and ignore it.
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
                if self.stream is not None:
                    k_eff = self._k_eff(k)
                    res = self._knn_adaptive(qs[a:b], k_eff, deadline)
                    res = self._merge_overlay_knn(res, qs[a:b], k)
                else:
                    res = self._knn_adaptive(qs[a:b], k, deadline)
                out.extend(res)
                certs.extend(
                    CompletenessCertificate.intact() for _ in range(b - a)
                )
            elif self.stream is not None:
                res = self._knn_streaming(
                    qs[a:b], k, runner, return_certs=return_certs,
                )
                if return_certs:
                    res, cs = res
                    certs.extend(cs)
                out.extend(res)
            elif self.sdev is not None:
                with self.table_lock.read():
                    res = knn_query_batch_sharded(
                        self.sdev, qs[a:b], k, runner=runner,
                        return_certs=return_certs,
                    )
                if return_certs:
                    res, cs = res
                    certs.extend(cs)
                out.extend(res)
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
                if self.sdev is not None:
                    res = [np.zeros(0, dtype=np.int64)] * (b - a)
                    hot = np.flatnonzero(~cold_q)
                    if hot.size:
                        hres, _ = window_query_batch_sharded(
                            self.sdev, los[a:b][hot], his[a:b][hot],
                            runner=runner, return_certs=True,
                        )
                        for qi, ids in zip(hot, hres):
                            res[qi] = ids
                else:
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
                if self.sdev is not None:
                    res, _cs = knn_query_batch_sharded(
                        self.sdev, qs[a:b], k, runner=runner,
                        return_certs=True,
                    )
                    res = list(res)
                    exact = np.ones(b - a, dtype=bool)
                else:
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
    def _journal_op(self, op: str, **args) -> None:  # analysis: caller-holds-write
        """Write-ahead: durably journal a cold host op before executing it
        (recovery replays exactly the journaled sequence).  An append that
        cannot be made durable fails the op — never execute unlogged.
        Callers hold the writer lock: journal seq must equal application
        order, so append and apply are one atomic writer section."""
        if self.journal is None:
            return

        def attempt():
            return self.journal.append(op, **args)

        self.retry.call(
            attempt, retry_on=(FaultError,), on_retry=self._count_retry,
            call_key="journal",
        )
        self.stats.journal_records += 1

    def _host_window(self, lo, hi) -> np.ndarray:  # analysis: caller-holds-write
        """Cold-path window: journal, then host-answer (+ refine) under
        retry.  Faults fire at entry, before any host mutation, so a
        retried attempt re-runs the op from scratch."""
        self._journal_op(
            "window", lo=[float(v) for v in lo], hi=[float(v) for v in hi]
        )

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
        self._journal_op("knn", q=[float(v) for v in q], k=int(k))

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
            if self.sdev is not None:
                # reaching an unrefined row == intersecting its MBB (hit
                # sets are downward-closed), so the host-side router test
                # equals the frontier's cold mask without a cross-shard
                # gather — and, being known up front, lets the device
                # serve only the hot part
                cold_q = (
                    boxes_intersect_windows(
                        t.mbb_lo[unref], t.mbb_hi[unref],
                        np.asarray(los, dtype=np.float64),
                        np.asarray(his, dtype=np.float64),
                    ).any(axis=1)
                    if len(unref)
                    else np.zeros(los.shape[0], dtype=bool)
                )
                out: list = [None] * los.shape[0]
                hot = np.flatnonzero(~cold_q)
                if hot.size:
                    res, cs = window_query_batch_sharded(
                        self.sdev, los[hot], his[hot], runner=runner,
                        return_certs=True,
                    )
                    for qi, ids, cert in zip(hot, res, cs):
                        if cert.complete:
                            out[qi] = ids
                        else:  # dead shard: exact host answer instead
                            cold_q[qi] = True
                            self.stats.host_fallbacks += 1
            else:
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
            if self.sdev is not None:
                res, cs = knn_query_batch_sharded(
                    self.sdev, qs, k, runner=runner, return_certs=True,
                )
                res = list(res)
                for i, cert in enumerate(cs):
                    if not cert.certified_exact:
                        degraded[i] = True
                        self.stats.host_fallbacks += 1
            else:
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

    # -- streaming ingest ----------------------------------------------------
    # The stream (host LSM tiers + delta) is authoritative; the device
    # serves the mirror of its tiers, tombstones filter host-side, and the
    # not-yet-flushed delta rows are unioned in by brute force (they are
    # few by construction: at most delta_threshold).
    def _ensure_stream(self):  # analysis: caller-holds-write
        if self.stream is None:
            if not self.adaptive:
                raise ValueError(
                    "ingest needs a streaming or adaptive server — boot "
                    "with from_streaming(...) or from_ambi(...)"
                )
            # adaptive overlay: the AMBI rows stay where they are (ids
            # [0, n) keep meaning buffer rows); only new points get tiered
            self.stream = StreamingIndex(
                self._points, store=self.ambi.store, base_external=True,
                **self.OVERLAY_KW,
            )
            _san.bind(self.stream, self.table_lock)
        return self.stream

    def insert(self, pts) -> np.ndarray:
        """Ingest points; returns their assigned ids.  Journaled (when
        durable), applied under the writer lock, and any tier flush/merge
        it triggers ships to the device before the lock drops.  If that
        upload fails with an error that is not an injected fault, the
        points are in all the same: ``StreamSyncError`` carries their ids."""
        pts = self._validate_batch(pts, "pts")
        if self.stream is None and not self.adaptive:
            raise ValueError(
                "this server is static — boot with from_streaming(...) "
                "or from_ambi(...) to ingest"
            )
        with self.table_lock.write():
            stream = self._ensure_stream()
            # journal inside the writer section: journal seq must match
            # application order or replay assigns different ids than the
            # live run acknowledged to clients
            self._journal_op(
                "insert", pts=[[float(v) for v in p] for p in pts]
            )
            ids = stream.insert(pts)
            self.stats.inserts += len(pts)
            self._sync_committed("insert", ids, ids)
        return ids

    def delete(self, ids) -> int:
        """Tombstone ids; returns how many were newly deleted.  The points
        stay physically present until a merge rewrites their tier — queries
        filter them immediately.  A failed upload raises
        ``StreamSyncError`` as ``insert`` does: the ids are deleted."""
        ids = np.unique(np.asarray(ids, dtype=np.int64).ravel())
        if self.stream is None and not self.adaptive:
            raise ValueError(
                "this server is static — boot with from_streaming(...) "
                "or from_ambi(...) to ingest"
            )
        with self.table_lock.write():
            stream = self._ensure_stream()
            # validate before journaling (and journal under the lock, in
            # application order): a durable record that deterministically
            # raises would make every subsequent recover() fail
            if len(ids) and (ids[0] < 0 or ids[-1] >= stream.n_ids):
                raise IndexError("delete id out of range")
            self._journal_op("delete", ids=[int(i) for i in ids])
            n = stream.delete(ids)
            self.stats.deletes += n
            self._sync_committed("delete", ids, n)
        return n

    def _sync_committed(self, op, ids, result):  # analysis: caller-holds-write
        """``_sync_stream_device`` after a committed op: its error says
        that the op is in, so that the caller does not apply it twice."""
        try:
            self._sync_stream_device()
        except Exception as e:
            raise StreamSyncError(op, ids, result, e) from e

    def _sync_stream_device(self) -> None:  # analysis: caller-holds-write
        """Ship the stream's structural events (tier attach/merge) to the
        device.  Caller holds the writer lock.  Single device: one
        ``apply_delta`` of the mirror (only new leaf blocks upload)
        against the stream's live point buffer, which moves as it grows.
        Sharded: plan surgery + per-changed-shard refresh.  The adaptive
        overlay has no mirror — its tiers serve host-side.

        An upload that exhausts its retries (injected faults) leaves the
        device stale and the host authoritative until a later sync lands
        it.  Any other error is raised unretried; the export then missed
        this sync, so streaming queries raise it too until one lands."""
        if self.mirror is None:
            return
        info = self.mirror.sync()
        if (info is None and not self._stream_stale_shards
                and not self._stream_device_stale):
            return
        self.stats.stream_syncs += 1

        def upload():
            if self.fault_plan is not None:
                self.fault_plan.fire("apply_delta")
            if self.sdev is not None:
                self._stream_refresh_shards(
                    self._stream_pending_syncs + [info]
                )
            else:
                self.dev = self.dev.apply_delta(
                    self.mirror.table, self.stream.points
                )
                self.stats.delta_refreshes += 1
            self._stream_device_stale = False
            self._stream_device_error = None

        try:
            self.retry.call(
                upload, retry_on=(FaultError,), on_retry=self._count_retry,
                call_key="apply_delta",
            )
        except RetryExhausted:
            # device stale, host authoritative: streaming queries serve
            # host-side until a later sync lands the upload, re-entered on
            # the next sync even if it carries no new events.  Sharded
            # keeps this sync's summary for the plan surgery it missed
            # (the reference drops it, and its shards never receive the
            # flushed tier: ROADMAP C.6).
            if self.sdev is not None and info is not None:
                self._stream_pending_syncs.append(info)
            self._stream_device_stale = True
        except Exception as e:
            # not an injected fault: raised, never answered from the host
            # (sharded: the shards left behind stay in _stream_stale_shards
            # for the next sync to re-export)
            self._stream_device_stale = True
            self._stream_device_error = e
            raise

    def _stream_refresh_shards(self, infos) -> None:  # analysis: caller-holds-write
        """Rewrite the shard plans through the mirror's sync summaries
        (``None`` where a sync carried no event), in order, and re-export
        only the shards whose content changed.

        Root copies that merely *moved* (the per-sync root-block rebuild,
        fusion adopting old roots) are remapped in the plan without a
        refresh — their subtree content is identical.  Shards lose plan
        entries when a rebuild-merge retires their tiers and gain the
        merged/attached roots back, preferring empty shards then the
        smallest."""
        sdev = self.sdev
        # the stream's buffer reallocates as it grows; refresh gathers
        # coordinates through source_points, so rebind the live view
        sdev.source_points = self.stream.points
        changed = set(self._stream_stale_shards)
        self._stream_stale_shards = set()
        self._stream_pending_syncs = []
        for info in infos:
            if info is None:
                continue
            remap = info["remap"]
            retired = info["retired"]
            plans = sdev.shard_roots
            for s in range(sdev.m):
                new_plan = []
                for r in plans[s]:
                    r = int(remap.get(int(r), int(r)))
                    if any(lo <= r < hi for lo, hi in retired):
                        changed.add(s)
                        continue
                    if r not in new_plan:
                        new_plan.append(r)
                plans[s] = new_plan
            placed = {r for p in plans for r in p}
            pool = [int(r) for r in info["add_rows"] if r not in placed]
            n_empty = sum(1 for p in plans if not p)
            if pool and len(pool) < n_empty:
                # a cascade merged everything a shard owned into one tier:
                # expand the widest new root into its child rows (the same
                # frontier move shard_plan makes at boot) until every
                # shard can keep a subspace
                t = self.mirror.table
                sizes = t.subtree_points()
                while len(pool) < n_empty:
                    exp = [r for r in pool if t.child_count[r] > 0]
                    if not exp:
                        break
                    r = max(exp, key=lambda r: int(sizes[r]))
                    pool.remove(r)
                    fc, cc = int(t.first_child[r]), int(t.child_count[r])
                    pool.extend(range(fc, fc + cc))
            for r in pool:
                empties = [s for s in range(sdev.m) if not plans[s]]
                s = (empties[0] if empties else
                     min(range(sdev.m),
                         key=lambda s: int(sdev.shards[s].n_points)))
                plans[s].append(int(r))
                changed.add(s)
            for s in range(sdev.m):
                if plans[s]:
                    continue
                donors = [d for d in range(sdev.m) if len(plans[d]) > 1]
                if donors:
                    d = max(donors,
                            key=lambda d: int(sdev.shards[d].n_points))
                    plans[s].append(plans[d].pop())
                    changed.update((s, d))
                else:
                    # cannot keep m nonempty subspaces: full re-shard
                    # (the delta-only acceptance counter pins this to 0)
                    self.sdev = ShardedDeviceTable.from_table(
                        self.mirror.table, self.stream.points,
                        self.requested_shards, stats=self.upload_stats,
                        compressed=self.compressed, device=self.device,
                    )
                    self.stats.stream_reshards += 1
                    return
        if changed:
            try:
                sdev.refresh(sorted(changed))
            except Exception:
                self._stream_stale_shards = changed
                raise
            self.stats.shard_refreshes += len(changed)

    def _k_eff(self, k: int) -> int:
        """k-NN over-fetch for tombstones: each component's top-(k+shadow)
        must contain its k best live rows.  Bucketed to the next power of
        two so a drifting shadow count reuses compiled k-variants."""
        shadow = self.stream.shadow if self.stream is not None else 0
        if shadow == 0:
            return k
        return max(k, 1 << (k + shadow - 1).bit_length())

    def _stream_is_stale(self) -> bool:
        """Device copies known to be missing just-flushed tier rows (a
        failed upload): the host stream answers exactly until the next
        sync converges the device.  An upload that failed with an error
        that is not an injected fault is raised instead."""
        if self._stream_device_error is not None:
            stale = sorted(self._stream_stale_shards) or [0]
            raise RuntimeError(
                "the device export missed a stream sync; the next insert "
                f"or delete, or repair({stale}), uploads it again"
            ) from self._stream_device_error
        return self._stream_device_stale or bool(self._stream_stale_shards)

    def _window_streaming(self, los, his, runner, *,
                          return_certs: bool = False):
        """Streaming window: device fan-out + tombstone filter + delta
        union.  A stale device or a single-device outage falls back to
        the authoritative host stream (exact, intact certificates); a
        sharded outage under ``return_certs`` serves degraded with the
        protocol's real per-shard certificates."""
        with self.table_lock.read():
            stream = self.stream
            certs = [CompletenessCertificate.intact() for _ in los]
            if self._stream_is_stale():
                out = stream.window(los, his)
                return (out, certs) if return_certs else out
            if self.sdev is not None:
                res = window_query_batch_sharded(
                    self.sdev, los, his, runner=runner,
                    return_certs=return_certs,
                )
                if return_certs:
                    res, certs = res
            else:
                try:
                    res = runner(0, lambda: window_query_batch_torch(
                        self.dev, los, his,
                    ))
                except ShardUnavailable:
                    out = stream.window(los, his)
                    return (out, certs) if return_certs else out
            pend = stream.delta_live_rows()
            if len(pend):
                p = stream.points[pend]
                inside = ((p[None, :, :] >= los[:, None, :])
                          & (p[None, :, :] <= his[:, None, :])).all(axis=2)
            out = []
            for i, ids in enumerate(res):
                ids = stream.filter_live(np.asarray(ids, dtype=np.int64))
                if len(pend):
                    ids = np.concatenate([ids, pend[inside[i]]])
                out.append(np.sort(ids))
        return (out, certs) if return_certs else out

    def _knn_streaming(self, qs, k: int, runner, *,
                       return_certs: bool = False):
        """Streaming k-NN: the device's top-``k_eff`` (over-fetched past
        the tombstones), filtered, unioned with the delta rows and
        re-ranked by f64 distance (ties by id)."""
        with self.table_lock.read():
            stream = self.stream
            certs = [CompletenessCertificate.intact() for _ in qs]
            if self._stream_is_stale():
                out = stream.knn(qs, k)
                return (out, certs) if return_certs else out
            n_phys = int(self.sdev.n_points if self.sdev is not None
                         else self.dev.live_points())
            k_eff = min(self._k_eff(k), n_phys)
            res = [np.empty(0, dtype=np.int64)] * len(qs)
            if k_eff > 0:
                if self.sdev is not None:
                    res = knn_query_batch_sharded(
                        self.sdev, qs, k_eff, runner=runner,
                        return_certs=return_certs,
                    )
                    if return_certs:
                        res, certs = res
                else:
                    try:
                        res = runner(0, lambda: knn_query_batch_torch(
                            self.dev, qs, k_eff,
                        ))
                    except ShardUnavailable:
                        out = stream.knn(qs, k)
                        return (out, certs) if return_certs else out
            pend = stream.delta_live_rows()
            pts = stream.points
            out = []
            for i in range(len(qs)):
                ids = stream.filter_live(np.asarray(res[i], dtype=np.int64))
                if len(pend):
                    ids = np.concatenate([ids, pend])
                ids = np.unique(ids)
                d2 = np.sum((pts[ids] - qs[i]) ** 2, axis=1)
                out.append(ids[np.lexsort((ids, d2))[:k]])
        return (out, certs) if return_certs else out

    def _merge_overlay_window(self, res, los, his) -> list[np.ndarray]:
        """Union an adaptive microbatch's base answers with the streaming
        overlay's, filtering base rows tombstoned by delete()."""
        with self.table_lock.read():
            s = self.stream
            over = s.window(los, his)
            out = []
            for base_ids, ov in zip(res, over):
                ids = s.filter_live(np.asarray(base_ids, dtype=np.int64))
                out.append(np.sort(np.concatenate([ids, ov])))
        return out

    def _merge_overlay_knn(self, res, qs, k: int) -> list[np.ndarray]:
        """Two-level top-k: the base path served top-k_eff physical rows
        (enough to survive tombstone filtering), the overlay serves its
        own top-k live; rank the union by exact f64 distance."""
        with self.table_lock.read():
            s = self.stream
            over = s.knn(qs, k)
            pts = s.points
            out = []
            for i, (base_ids, ov) in enumerate(zip(res, over)):
                ids = s.filter_live(np.asarray(base_ids, dtype=np.int64))
                ids = np.unique(np.concatenate([ids, ov]))
                d2 = np.sum((pts[ids] - qs[i]) ** 2, axis=1)
                out.append(ids[np.lexsort((ids, d2))[:k]])
        return out

    def _after_refinement(self, before_unref: np.ndarray) -> None:  # analysis: caller-holds-write
        """Push the microbatch's grafts to the device: incremental delta
        (single table) or per-changed-shard re-export (sharded), then
        vacuum the host table if grafting bloated it.

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
            if self.sdev is not None:
                if self.sdev.m < self.requested_shards:
                    # a boot from a barely refined table (ultimately the
                    # single-unrefined-root state, where the plan is [[0]])
                    # cannot cut m subspaces yet; re-plan once the grafts
                    # grow the tree far enough instead of full-re-exporting
                    # the one degenerate whole-table "shard" on every graft
                    sizes = t.subtree_points()
                    if len(t.shard_plan(
                        self.requested_shards, sizes
                    )) > self.sdev.m:
                        self.sdev = ShardedDeviceTable.from_table(
                            t, self.points, self.requested_shards,
                            partial=True, stats=self.upload_stats,
                            compressed=self.compressed, device=self.device,
                        )
                        self.stats.shards = self.sdev.m
                        self.stats.shard_refreshes += self.sdev.m
                        return
                changed = self.sdev.shards_of_rows(grafted)
                self.sdev.refresh(changed)
                self.stats.shard_refreshes += len(changed)
            else:
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
        device table's row maps (or the shard plan) through the returned
        remap.  With a
        journal, the vacuum is itself a journaled op (replay must compact
        at the same point to stay bit-identical) and doubles as the
        snapshot barrier: checkpoint, then truncate the folded journal."""
        t = self.ambi.table
        if t.n_perm > (1.0 + self.compact_slack) * len(self.points):
            # the compact() row remap and the device/shard rebase must be
            # one atomic writer section: a concurrent apply_delta swap (or
            # reader capturing row indices) between them would observe a
            # half-rebased slot map.  Callers enter through the adaptive
            # write sections; this pins the invariant for new call sites.
            assert self.table_lock.held_write(), (
                "_maybe_compact requires the TableLock writer section"
            )
            if self.journal is not None:
                try:
                    self._journal_op("compact")
                except RetryExhausted:
                    return  # not durably logged -> defer the vacuum
            remap = t.compact()
            if self.sdev is not None:
                self.sdev.remap_source_rows(remap)
            else:
                self.dev.remap_rows(remap)
            self._table_version += 1
            self.stats.compactions += 1
            if self.snapshot_path is not None:
                try:
                    self._checkpoint_locked()
                except RetryExhausted:
                    pass  # barrier deferred; journal still holds the ops

    # -- durability: snapshot barriers + crash recovery ----------------------
    def checkpoint(self) -> None:
        """Durable snapshot barrier: atomically persist the table, the
        dataset, and the adaptive state (rng + page store), or a streaming
        server's stream, recording the journal's high-water ``seq``; then
        truncate the journal (its records are folded into the snapshot).
        Crash-ordering: the snapshot lands via atomic rename *before* the
        truncate, and recovery skips records at or below the recorded seq
        — a kill between the two replays nothing twice.

        Takes the writer lock: the snapshot must capture a quiesced
        state, and the captured seq, the saved bytes, and the truncate
        must not interleave with a concurrent writer (a journal record
        folded into no snapshot but truncated anyway would be lost).
        ``_maybe_compact`` calls :meth:`_checkpoint_locked` directly —
        it already holds the writer section (TableLock is not
        reentrant)."""
        if self.snapshot_path is None:
            raise ValueError("no snapshot_path configured")
        with self.table_lock.write():
            self._checkpoint_locked()

    def _checkpoint_locked(self) -> None:  # analysis: caller-holds-write
        if self.snapshot_path is None:
            raise ValueError("no snapshot_path configured")

        def attempt():
            if self.fault_plan is not None:
                self.fault_plan.fire("snapshot_save", path=self.snapshot_path)
            seq = self.journal.seq if self.journal else 0
            if self.stream is not None and not self.adaptive:
                # streaming barrier: the stream IS the authoritative state
                # (points, tombstones, tiers, store); the mirror is derived
                # and rebuilt at boot
                self.stream.save(self.snapshot_path,
                                 extra={"journal_seq": seq})
                return
            self.ambi.table.save(
                self.snapshot_path, points=self._points,
                extra={
                    "ambi_state": self.ambi.state_meta(),
                    "journal_seq": seq,
                },
            )
            if self.stream is not None:
                # adaptive overlay rides along as a sidecar in the same
                # barrier.  The two saves are not atomic as a pair: a
                # crash in between leaves the old sidecar next to the new
                # base, so recovery replays ingest from the sidecar's OWN
                # recorded seq, not the base's (see recover())
                self.stream.save(self._overlay_sidecar(),
                                 extra={"journal_seq": seq})

        self.retry.call(
            attempt, retry_on=(FaultError,), on_retry=self._count_retry,
            call_key="snapshot",
        )
        if self.journal is not None:
            self.journal.truncate()
        self.stats.checkpoints += 1

    def _overlay_sidecar(self) -> str:
        return self.snapshot_path[:-len(".npz")] + ".stream.npz"

    @staticmethod
    def _replay_op(ambi, rec: dict) -> None:  # analysis: single-threaded(boot-time replay precedes serving)
        op = rec.get("op")
        if op == "window":
            ambi.window(
                np.asarray(rec["lo"], dtype=np.float64),
                np.asarray(rec["hi"], dtype=np.float64),
            )
        elif op == "knn":
            ambi.knn(np.asarray(rec["q"], dtype=np.float64), int(rec["k"]))
        elif op == "compact":
            ambi.table.compact()
        else:
            raise JournalError(f"unknown journal op {op!r} (seq {rec.get('seq')})")

    @classmethod
    def recover(cls, snapshot_path, journal_path, *,  # analysis: single-threaded(recovery runs before the server takes traffic)
                fault_plan=None, **kw) -> "DeviceQueryServer":
        """Reboot a killed adaptive or streaming server: load the snapshot,
        replay the journal's post-barrier records against the restored
        state (grafting is deterministic given the snapshot's rng +
        page-store state, so the table lands bit-identical to the
        uninterrupted server's), then resume serving with the same
        durability config.  ``device``, ``shards`` and the other keywords
        go to the new server.  Snapshots and journals of the JAX package's server
        recover here too (same formats).

        The fault plane is disarmed for the replay — recovery re-executes
        already-acknowledged ops and must not be re-faulted — and rearmed
        before the recovered server takes traffic."""
        snapshot_path = os.fspath(snapshot_path)
        if not snapshot_path.endswith(".npz"):
            snapshot_path += ".npz"
        if fault_plan is not None:
            fault_plan.fire("snapshot_load", path=snapshot_path)
        if StreamingIndex.is_stream_snapshot(snapshot_path):
            # streaming server: restore the stream, replay post-barrier
            # ingest on the host, then boot (the mirror and device exports
            # are derived state, rebuilt fresh from the restored tiers)
            stream, meta = StreamingIndex.load(snapshot_path)
            snap_seq = int(meta["journal_seq"])
            was_armed = fault_plan is not None and fault_plan.armed
            if was_armed:
                fault_plan.disarm()
            replayed = 0
            try:
                for rec in GraftJournal.read_records(
                    journal_path, after_seq=snap_seq
                ):
                    cls._replay_ingest(stream, rec)
                    replayed += 1
            finally:
                if was_armed:
                    fault_plan.rearm()
            srv = cls.from_streaming(
                stream, snapshot_path=snapshot_path,
                journal_path=journal_path, fault_plan=fault_plan, **kw,
            )
            srv.journal.seq = max(srv.journal.seq, snap_seq)
            srv.stats.replayed_records = replayed
            return srv
        table, meta, points = NodeTable.load(snapshot_path)
        if points is None or "ambi_state" not in meta:
            raise ValueError(
                "recovery snapshot must carry points and adaptive state "
                "(written by DeviceQueryServer.checkpoint)"
            )
        ambi = AMBI.from_table_state(
            np.asarray(points), table, str(meta["ambi_state"])
        )
        snap_seq = int(meta["journal_seq"])
        # the base snapshot and the overlay sidecar are two files written
        # in sequence — a crash between them leaves the sidecar at the
        # *previous* barrier's seq.  Each file keeps its own replay
        # cursor: ambi ops resume after the base's seq, ingest ops after
        # the sidecar's own recorded seq (0 when no sidecar exists — no
        # ingest was ever folded, so every journaled ingest op replays).
        overlay = None
        overlay_seq = 0
        sidecar = snapshot_path[:-len(".npz")] + ".stream.npz"
        if os.path.exists(sidecar):
            overlay, ometa = StreamingIndex.load(sidecar)
            overlay_seq = int(ometa["journal_seq"])
            if overlay_seq == snap_seq:
                # one barrier saved both files from the one page store the
                # live overlay shares with AMBI: share it again, so replay
                # allocates pages and charges I/O as the live server did
                # (the reference keeps the sidecar's copy: ROADMAP C.5)
                overlay.store = ambi.store
        was_armed = fault_plan is not None and fault_plan.armed
        if was_armed:
            fault_plan.disarm()
        replayed = 0
        try:
            for rec in GraftJournal.read_records(
                journal_path, after_seq=min(snap_seq, overlay_seq)
            ):
                if rec.get("op") in ("insert", "delete"):
                    if int(rec.get("seq", 0)) <= overlay_seq:
                        continue  # already folded into the sidecar
                    if overlay is None:
                        overlay = StreamingIndex(
                            np.asarray(points), store=ambi.store,
                            base_external=True, **cls.OVERLAY_KW,
                        )
                    cls._replay_ingest(overlay, rec)
                else:
                    if int(rec.get("seq", 0)) <= snap_seq:
                        continue  # already folded into the base snapshot
                    cls._replay_op(ambi, rec)
                replayed += 1
        finally:
            if was_armed:
                fault_plan.rearm()
        srv = cls.from_ambi(
            ambi, snapshot_path=snapshot_path, journal_path=journal_path,
            fault_plan=fault_plan, **kw,
        )
        srv.stream = overlay
        if overlay is not None:
            _san.bind(overlay, srv.table_lock)
        srv.journal.seq = max(srv.journal.seq, snap_seq)
        srv.stats.replayed_records = replayed
        return srv

    @staticmethod
    def _replay_ingest(stream, rec: dict) -> None:  # analysis: single-threaded(boot-time replay precedes serving)
        op = rec.get("op")
        if op == "insert":
            stream.insert(np.asarray(rec["pts"], dtype=np.float64))
        elif op == "delete":
            stream.delete(np.asarray(rec["ids"], dtype=np.int64))
        else:
            raise JournalError(
                f"unknown journal op {op!r} (seq {rec.get('seq')})"
            )
