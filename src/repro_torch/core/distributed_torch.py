"""Sharded device engine (paper Section 5 on the ``DeviceTable``): m
per-shard exports behind a subspace-MBB router, windows fanned out to the
qualified shards, and the two-round certified k-NN protocol.

The port of the host-routed half of the JAX package's
``repro/core/distributed_jax.py``:

  * :class:`ShardedDeviceTable`: ``NodeTable.shard_plan`` partitions a
    bulk-loaded (or ``NodeTable.merged``) table into m per-shard
    ``DeviceTable`` exports plus a *router*, the shard subspace MBBs.
    Every shard addresses the global dataset (shard ``perm`` entries are
    global row ids), so results merge by concatenation.  All shards live
    on one device (``cuda`` unless the caller names another), as the
    reference keeps all of its shards on its default device.
  * :func:`window_query_batch_sharded`: windows fan out only to the
    shards whose router MBB intersects the query box (the paper's
    "qualified servers"); each shard serves its sub-batch through
    ``window_query_batch_torch`` and per-query ids concatenate.
  * :func:`knn_query_batch_sharded`: the two-round SpatialHadoop
    protocol.  Round 1 sends each query to its *home* shard (smallest
    router mindist); the k-th local distance is the certified pruning
    radius.  Round 2 escalates exactly the (query, shard) pairs whose
    router mindist is within the radius.

With a ``runner`` (the serving layer's retry and breaker hook) a shard
outage degrades a batch to per-query :class:`CompletenessCertificate`s.
Single-device serving (``serve/engine.py:DeviceQueryServer``) speaks the
same protocol: its one device is shard 0.

Router arithmetic runs in float32, the dtype the per-shard engine tests
leaf boxes in, so the routed visit set is a superset of the leaves the
single-table engine scans.

The collective formulation (``knn_batch_shard_map``,
``window_count_batch_shard_map``) runs on a ``torch.distributed`` process
group with one rank per shard (``mesh.py``; the reference's ``shard_map``
over a device mesh), over the layout :meth:`ShardedDeviceTable.stacked`
gives.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops
from .distributed import gather_topk_merge
from .geometry import boxes_intersect_windows, boxes_mindist_sq
from .mesh import all_reduce_sum
from .nodetable import NodeTable
from .queries_torch import (
    BIG,
    DeviceTable,
    _knn_core,
    knn_query_batch_torch,
    resolve_device,
    window_query_batch_torch,
)


class ShardUnavailable(RuntimeError):
    """A shard cannot serve (dispatch failed past retry / breaker open).

    Raised *into* the query protocols by the injected ``runner``; with
    ``return_certs=True`` the server degrades (answers from the remaining
    shards + a per-query certificate), without it the outage propagates
    to the caller unchanged.
    """

    def __init__(self, shard: int, reason: str = ""):
        self.shard = int(shard)
        super().__init__(
            f"shard {shard} unavailable" + (f": {reason}" if reason else "")
        )


@dataclasses.dataclass
class CompletenessCertificate:
    """Per-query provenance of a (possibly degraded) sharded answer.

    ``complete`` — every shard relevant to this query answered; the result
    is exactly the healthy protocol's.  ``certified_exact`` — the returned
    ids are provably the exact answer even if shards were down: trivially
    true when complete, and true for k-NN when every down shard's router
    mindist strictly exceeds the k-th returned f32 distance (the same
    exclusion certificate round 2 escalates on).  ``missing_shards`` / ``missing_lo`` /
    ``missing_hi`` are the unanswered subspaces that *could* affect the
    answer (empty iff ``certified_exact``): the repair queue, and for a
    window query the region the caller must treat as unknown.
    """

    complete: bool
    certified_exact: bool
    missing_shards: tuple = ()
    missing_lo: np.ndarray = None  # (u, d) f32 router MBBs, row per shard
    missing_hi: np.ndarray = None

    @classmethod
    def intact(cls) -> "CompletenessCertificate":
        return cls(complete=True, certified_exact=True)

    @classmethod
    def degraded(
        cls, sdev: "ShardedDeviceTable", missing, *, exact: bool = False
    ) -> "CompletenessCertificate":
        missing = tuple(int(s) for s in missing)
        return cls(
            complete=False,
            certified_exact=exact and not missing,
            missing_shards=missing,
            missing_lo=sdev.shard_lo[list(missing)].copy(),
            missing_hi=sdev.shard_hi[list(missing)].copy(),
        )


def _run_shard(runner, s: int, thunk):
    """One shard dispatch through the injected resilience runner (or
    directly when serving without one)."""
    if runner is None:
        return thunk()
    return runner(int(s), thunk)


# --------------------------------------------------------------------------
# sharded table: m DeviceTables + the subspace-MBB router
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ShardedDeviceTable:
    """m per-shard :class:`DeviceTable` exports behind an MBB router.

    When built through :meth:`from_table` the instance remembers its
    source table, dataset, and each shard's subspace root rows, so the
    adaptive serving path can re-export *only* the shards whose subspaces
    a graft touched (:meth:`refresh`) instead of re-sharding the world.
    """

    shards: list
    shard_lo: np.ndarray  # (m, d) float32 router MBBs (shard root boxes)
    shard_hi: np.ndarray
    n_points: int
    source_table: NodeTable = None   # refresh scaffolding (from_table only)
    source_points: np.ndarray = None
    shard_roots: list = None         # per shard: source-table root rows
    partial: bool = False
    upload_stats: object = None      # UploadStats sink for (re)exports
    compressed: bool = False         # bf16 compressed-MBB shard exports

    @property
    def m(self) -> int:
        return len(self.shards)

    @property
    def dim(self) -> int:
        return int(self.shard_lo.shape[1])

    @property
    def device(self):
        return self.shards[0].device

    @classmethod
    def from_tables(
        cls,
        tables: list[NodeTable],
        points: np.ndarray,
        *,
        partial: bool = False,
        stats=None,
        compressed: bool = False,
        device=None,
    ) -> "ShardedDeviceTable":
        """From per-shard tables whose ``perm`` entries are global row ids
        (``NodeTable.shard`` output), each exported to ``device`` (``cuda``
        unless given; raises without a card)."""
        if not tables:
            raise ValueError("need at least one shard table")
        dev = resolve_device(device)
        points = np.asarray(points)
        shards = [
            DeviceTable.from_table(t, points, partial=partial, stats=stats,
                                   compressed=compressed, device=dev)
            for t in tables
        ]
        return cls(
            shards=shards,
            shard_lo=np.stack([t.mbb_lo[0].astype(np.float32) for t in tables]),
            shard_hi=np.stack([t.mbb_hi[0].astype(np.float32) for t in tables]),
            n_points=int(sum(s.n_points for s in shards)),
            partial=partial,
            upload_stats=stats,
            compressed=compressed,
        )

    @classmethod
    def from_table(
        cls,
        table: NodeTable,
        points: np.ndarray,
        m: int,
        *,
        partial: bool = False,
        stats=None,
        compressed: bool = False,
        device=None,
    ) -> "ShardedDeviceTable":
        sizes = table.subtree_points()
        plan = table.shard_plan(m, sizes)
        tables = [cls._extract(table, roots, sizes) for roots in plan]
        self = cls.from_tables(tables, points, partial=partial, stats=stats,
                               compressed=compressed, device=device)
        self.source_table = table
        self.source_points = np.asarray(points)
        self.shard_roots = plan
        return self

    @staticmethod
    def _extract(table: NodeTable, roots, sizes) -> NodeTable:
        if list(roots) == [0]:
            return table
        return table.subtable(roots, sizes=sizes)

    # -- adaptive refresh ---------------------------------------------------
    def shards_of_rows(self, rows) -> list[int]:
        """Which shards own the given source-table rows (ancestor climb
        through the parent array — grafted rows always hang below a root
        that existed when the shard plan was made)."""
        if self.shard_roots is None:
            raise ValueError("no shard plan recorded; build via from_table")
        owner = {int(r): s for s, b in enumerate(self.shard_roots) for r in b}
        par = self.source_table.parent_rows()
        out: set[int] = set()
        for r in rows:
            r = int(r)
            while r >= 0 and r not in owner:
                r = int(par[r])
            if r >= 0:
                out.add(owner[r])
        return sorted(out)

    def refresh(self, shard_ids) -> None:
        """Re-export only the listed shards from the (grafted) source
        table, each whole, to the device the shards live on — the delta
        unit of the sharded serving path: a graft invalidates exactly the
        shard owning its subspace, every other shard's device arrays are
        untouched."""
        if self.source_table is None:
            raise ValueError("no source recorded; build via from_table")
        sizes = self.source_table.subtree_points()
        dev = self.device
        for s in sorted(set(int(s) for s in shard_ids)):
            t = self._extract(self.source_table, self.shard_roots[s], sizes)
            self.shards[s] = DeviceTable.from_table(
                t, self.source_points, partial=self.partial,
                stats=self.upload_stats, compressed=self.compressed, device=dev,
            )
            self.shard_lo[s] = t.mbb_lo[0].astype(np.float32)
            self.shard_hi[s] = t.mbb_hi[0].astype(np.float32)
        self.n_points = int(sum(s.n_points for s in self.shards))

    def remap_source_rows(self, remap: np.ndarray) -> None:
        """Rebase the shard plan after ``NodeTable.compact``."""
        if self.shard_roots is not None:
            self.shard_roots = [
                [int(remap[r]) for r in b] for b in self.shard_roots
            ]

    @classmethod
    def from_index(
        cls, index, m: int, *, compressed: bool = False, device=None
    ) -> "ShardedDeviceTable":
        """From a built ``core.fmbi.Index`` (or a refined AMBI's ``.index``)."""
        return cls.from_table(index.table, index.points, m,
                              compressed=compressed, device=device)

    @classmethod
    def from_parallel_build(
        cls, build, points: np.ndarray, *, device=None
    ) -> "ShardedDeviceTable":
        """From a host m-server simulation (``parallel_bulk_load``): the
        merged table's server subtrees become the shards verbatim, so the
        device layout and the Figure-11 simulation share one
        representation."""
        merged = build.merged_table()
        m = int(merged.child_count[0])
        tables = [merged.subtable([1 + s]) for s in range(m)]
        return cls.from_tables(tables, points, device=device)

    def stacked(self) -> dict:
        """Uniform (m, L, S, ·) leaf layout for a collective round, as host
        NumPy arrays.

        Shards pad to the widest leaf table with empty leaves (inverted
        MBBs, f32-max coordinates, zero fill counts) that every masked
        test already ignores.  Levels are not stacked — the collective
        round scans leaf blocks directly."""
        if any(s.n_cold for s in self.shards):
            raise ValueError(
                "stacked() needs fully refined shards (partial exports "
                "carry cold rows only the host-routed path can serve)"
            )
        L = max(s.n_leaves for s in self.shards)
        S = max(s.leaf_size for s in self.shards)
        d = self.dim
        m = self.m
        lp = np.full((m, L, S, d), BIG, dtype=np.float32)
        li = np.full((m, L, S), -1, dtype=np.int32)
        lc = np.zeros((m, L), dtype=np.int32)
        llo = np.full((m, L, d), BIG, dtype=np.float32)
        lhi = np.full((m, L, d), -BIG, dtype=np.float32)
        for s, dev in enumerate(self.shards):
            ls, ss = dev.n_leaves, dev.leaf_size
            lp[s, :ls, :ss] = dev.leaf_pts.cpu().numpy()
            li[s, :ls, :ss] = dev.leaf_ids.cpu().numpy()
            lc[s, :ls] = dev.leaf_counts.cpu().numpy()
            llo[s, :ls] = dev.leaf_lo.cpu().numpy()
            lhi[s, :ls] = dev.leaf_hi.cpu().numpy()
        return {
            "leaf_pts": lp, "leaf_ids": li, "leaf_counts": lc,
            "leaf_lo": llo, "leaf_hi": lhi, "n_points": self.n_points,
        }


# --------------------------------------------------------------------------
# distributed window: router fan-out + per-shard collection
# --------------------------------------------------------------------------
def window_query_batch_sharded(
    sdev: ShardedDeviceTable,
    los: np.ndarray,
    his: np.ndarray,
    *,
    fused: bool | None = None,
    runner=None,
    return_certs: bool = False,
) -> list[np.ndarray]:
    """Distributed batched window query: per-query global row-id arrays.

    Only qualified shards (router MBB intersects the box) receive a
    query, each shard serves its sub-batch through the device engine
    (``fused`` as in ``window_query_batch_torch``), and per-query results
    concatenate — the shards partition the dataset, so the union is
    id-identical (as a set) to the single-table engine.

    ``runner(shard_id, thunk)`` is the serving layer's resilience hook
    (retry + breaker around each shard dispatch); a runner that raises
    :class:`ShardUnavailable` marks the shard down.  With
    ``return_certs=True`` an outage *degrades* the batch — the return is
    ``(results, certs)`` where each :class:`CompletenessCertificate`
    names the unanswered subspace MBBs (a window over a dead shard can
    never be certified exact: any point of its subspace may qualify).
    Without it the outage propagates.
    """
    los = np.atleast_2d(np.asarray(los, dtype=np.float64))
    his = np.atleast_2d(np.asarray(his, dtype=np.float64))
    q0 = los.shape[0]
    hit = boxes_intersect_windows(
        sdev.shard_lo, sdev.shard_hi,
        los.astype(np.float32), his.astype(np.float32),
    )  # (Q, m) — f32, the dtype the per-shard engine tests boxes in
    parts: list[list[np.ndarray]] = [[] for _ in range(q0)]
    down: list[int] = []
    for s, dev in enumerate(sdev.shards):
        qsel = np.flatnonzero(hit[:, s])
        if qsel.size == 0:
            continue
        try:
            res = _run_shard(
                runner, s,
                lambda dev=dev, qsel=qsel: window_query_batch_torch(
                    dev, los[qsel], his[qsel], fused=fused,
                ),
            )
        except ShardUnavailable:
            if not return_certs:
                raise
            down.append(s)
            continue
        for qi, ids in zip(qsel, res):
            if len(ids):
                parts[qi].append(ids)
    results = [
        np.concatenate(p) if p else np.zeros(0, dtype=np.int64) for p in parts
    ]
    if not return_certs:
        return results
    certs = []
    for qi in range(q0):
        miss = [s for s in down if hit[qi, s]]
        certs.append(
            CompletenessCertificate.intact()
            if not miss
            else CompletenessCertificate.degraded(sdev, miss)
        )
    return results, certs


# --------------------------------------------------------------------------
# distributed k-NN: two rounds with a certified pruning radius
# --------------------------------------------------------------------------
def knn_query_batch_sharded(
    sdev: ShardedDeviceTable,
    qs: np.ndarray,
    k: int,
    *,
    fused: bool | None = None,
    runner=None,
    return_certs: bool = False,
) -> list[np.ndarray]:
    """Distributed batched k-NN: per-query ascending-distance global ids.

    Two rounds (paper Section 5 / SpatialHadoop).  Round 1: each query
    probes its home shard (smallest router mindist) for a local exact
    top-k; the k-th local f32 distance is the pruning radius (+inf when
    the shard holds fewer than k points).  Round 2: per query, every
    other shard whose router mindist is within the radius — the shards
    whose exclusion certificate *fails* — is probed too; shards outside
    the radius are certified non-contributing and never touched.  The
    final merge sorts each query's pooled (distance, id) candidates and
    keeps ``min(k, n)``; distances are the same f32 values the
    single-table engine computes, so ids match it exactly whenever
    distances are unique (ties at the k-th boundary are unspecified in
    both engines).

    Degraded mode (``runner`` + ``return_certs=True``, as for the window
    protocol): a query whose home shard is down re-routes round 1 to the
    next-closest *available* shard, round 2 skips down shards, and the
    per-query certificate applies the same f32 exclusion test to the dead
    shards — when every down shard's router mindist strictly exceeds the
    k-th returned distance the partial answer is ``certified_exact``
    (the shard provably holds no closer point); otherwise its subspace
    MBB is reported missing.
    """
    qs = np.atleast_2d(np.asarray(qs, dtype=np.float64))
    q0 = qs.shape[0]
    m = sdev.m
    # f32 router mindists: the same dtype (and box values) the per-shard
    # engine prunes leaves with, so certificates are mutually consistent
    minds = boxes_mindist_sq(
        sdev.shard_lo, sdev.shard_hi, qs.astype(np.float32)
    )
    cand_ids: list[list[np.ndarray]] = [[] for _ in range(q0)]
    cand_d2: list[list[np.ndarray]] = [[] for _ in range(q0)]
    probed = np.zeros((q0, m), dtype=bool)
    avail = np.ones(m, dtype=bool)

    def probe(s: int, qidx: np.ndarray) -> bool:
        def thunk():
            return knn_query_batch_torch(
                sdev.shards[s], qs[qidx], k, fused=fused, return_dists=True,
            )

        try:
            ids, d2 = _run_shard(runner, s, thunk)
        except ShardUnavailable:
            if not return_certs:
                raise
            avail[s] = False
            return False
        for qi, i_s, d_s in zip(qidx, ids, d2):
            cand_ids[qi].append(i_s)
            cand_d2[qi].append(d_s)
        probed[qidx, s] = True
        return True

    # round 1: home = closest *available* shard; a query whose home dies
    # mid-round re-routes to the next closest until one answers (or every
    # shard is down, in which case it has no round-1 radius)
    unhomed = np.arange(q0)
    while unhomed.size and avail.any():
        mm = np.where(avail[None, :], minds[unhomed], np.inf)
        homes = np.argmin(mm, axis=1)
        rerouted: list[np.ndarray] = []
        for s in np.unique(homes):
            qidx = unhomed[homes == s]
            if not probe(int(s), qidx):
                rerouted.append(qidx)
        unhomed = (
            np.concatenate(rerouted) if rerouted
            else np.zeros(0, dtype=np.int64)
        )

    # certified pruning radius: the k-th home-shard distance (ascending),
    # +inf when the home shard cannot fill k results on its own
    radius = np.full(q0, np.inf, dtype=np.float64)
    for qi in range(q0):
        if cand_d2[qi] and len(cand_d2[qi][0]) >= k:
            radius[qi] = float(cand_d2[qi][0][k - 1])

    # round 2: escalate exactly the (query, shard) pairs whose exclusion
    # certificate fails (router mindist within the radius; <= keeps ties)
    for s in range(m):
        if not avail[s]:
            continue
        need = np.flatnonzero(~probed[:, s] & (minds[:, s] <= radius))
        if need.size:
            probe(s, need)

    out: list[np.ndarray] = []
    out_d2: list[np.ndarray] = []
    keep = min(k, sdev.n_points)
    for qi in range(q0):
        if len(cand_ids[qi]) == 0:
            out.append(np.zeros(0, dtype=np.int64))
            out_d2.append(np.zeros(0, dtype=np.float32))
            continue
        if len(cand_ids[qi]) == 1:
            # single probed shard: its local top-k IS the global answer,
            # already in engine order (m=1, or a certified-complete home)
            out.append(cand_ids[qi][0][:keep].astype(np.int64))
            out_d2.append(cand_d2[qi][0][:keep])
            continue
        ids = np.concatenate(cand_ids[qi])
        d2 = np.concatenate(cand_d2[qi])
        order = np.argsort(d2, kind="stable")[:keep]
        out.append(ids[order].astype(np.int64))
        out_d2.append(d2[order])
    if not return_certs:
        return out
    down = np.flatnonzero(~avail)
    certs = []
    for qi in range(q0):
        if down.size == 0:
            certs.append(CompletenessCertificate.intact())
            continue
        # the same exclusion test round 2 uses, against the *final* k-th
        # distance: a down shard with mindist strictly beyond it provably
        # holds no point of the true top-k (a short result leaves the
        # k-th distance +inf, so nothing clears)
        kth = float(out_d2[qi][k - 1]) if len(out_d2[qi]) >= k else np.inf
        miss = [int(s) for s in down if not (minds[qi, s] > kth)]
        certs.append(CompletenessCertificate.degraded(sdev, miss, exact=True))
    return out, certs


# --------------------------------------------------------------------------
# collective rounds over a process group (one rank per shard)
# --------------------------------------------------------------------------
def _check_group(stacked: dict, group) -> np.ndarray:
    """The group must carry exactly one rank per shard; returns the
    stacked leaf-point array."""
    lp = stacked["leaf_pts"]
    if lp.shape[0] != group.size:
        raise ValueError(
            f"process group has {group.size} ranks but table has "
            f"{lp.shape[0]} shards"
        )
    return lp


def _rank_shard(stacked: dict, group) -> DeviceTable:
    """The rank's shard of a :meth:`ShardedDeviceTable.stacked` layout,
    uploaded to the group's device as a leaf-blocks-only
    :class:`DeviceTable` (no levels: the collective rounds scan leaf blocks
    directly).  Only the rank's slice is read, so the arrays may be memory
    maps."""
    lp = _check_group(stacked, group)
    r, dev = group.rank, group.device

    def up(name):
        return torch.from_numpy(np.array(stacked[name][r])).to(dev)

    counts = up("leaf_counts")
    none = torch.zeros((0, lp.shape[-1]), dtype=torch.float32, device=dev)
    return DeviceTable(
        leaf_pts=up("leaf_pts"), leaf_ids=up("leaf_ids"), leaf_counts=counts,
        leaf_lo=up("leaf_lo"), leaf_hi=up("leaf_hi"), levels=(), terminals=(),
        cold_lo=none, cold_hi=none, n_points=int(counts.sum()),
    )


def _f32_rows(a, device) -> torch.Tensor:
    return torch.from_numpy(np.atleast_2d(np.asarray(a, dtype=np.float32))).to(device)


def knn_batch_shard_map(
    stacked: dict, qs: np.ndarray, k: int, group,
) -> tuple[np.ndarray, np.ndarray]:
    """Two-round k-NN as one collective over a process group, called by
    every rank.

    ``stacked`` is :meth:`ShardedDeviceTable.stacked` (host arrays); the
    group plays the m local servers (its size must equal the shard count).
    Each rank uploads its shard and scans *all* of its leaf blocks
    (``_knn_core`` at the full budget: the local round is exact by
    construction), in query chunks so that one (queries x slots) distance
    plane stays within ``ops.KNN_MAX_ELEMS``; the global round is
    :func:`~.distributed.gather_topk_merge`.

    Returns ``(d2, ids)`` of shape (Q, k') on every rank, ascending per
    query, ``k' = min(k, L*S)``; entries beyond a query's reachable points
    carry ``id = -1`` at f32 max (the reference: ``+inf``)."""
    dev = _rank_shard(stacked, group)
    qt = _f32_rows(qs, dev.device)
    n_l, s = dev.n_leaves, dev.leaf_size
    chunk = max(ops.KNN_MAX_ELEMS // (n_l * s), 1)
    parts = [_knn_core(dev, qt[a:a + chunk], k, n_l)
             for a in range(0, max(qt.shape[0], 1), chunk)]
    ids = torch.cat([p[0] for p in parts])
    d2 = torch.cat([p[1] for p in parts])
    top_d2, sel, _ = gather_topk_merge(d2, ids, group, d2.shape[-1])
    return top_d2.cpu().numpy(), sel.cpu().numpy()


def window_count_batch_shard_map(
    stacked: dict, los: np.ndarray, his: np.ndarray, group,
) -> np.ndarray:
    """Exact batched window counts as one sum over a process group, called
    by every rank.

    Each rank counts its shard's points inside each window with
    ``ops.window_count`` over its (L*S, d) leaf points, the slots past a
    leaf's fill count masked out (no (Q, L, S) plane); the global count is
    the cross-rank sum.  Returns int32 counts (Q,) on every rank, as the
    reference does."""
    dev = _rank_shard(stacked, group)
    slot = torch.arange(dev.leaf_size, dtype=torch.int32, device=dev.device)
    valid = (slot[None, :] < dev.leaf_counts[:, None]).reshape(-1).to(torch.int32)
    local = ops.window_count(_f32_rows(los, dev.device), _f32_rows(his, dev.device),
                             dev.leaf_pts.reshape(-1, dev.dim), valid)
    return all_reduce_sum(group, local).cpu().numpy()
