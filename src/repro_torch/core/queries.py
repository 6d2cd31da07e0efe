"""Query processing over ``core`` indexes: window (range) and k-NN.

Both queries follow the paper's top-down traversal — visit every node whose
MBB may contain results, scan and filter leaves — but execute it against the
flat :class:`.nodetable.NodeTable` instead of an object graph:

  * **Window** queries run *level-synchronous frontier traversal*: the whole
    frontier's boxes are tested against the window with two broadcast
    comparisons, survivors expand through the CSR child ranges in one ragged
    gather, and all qualifying leaves are filtered with a single comparison
    over their concatenated ``perm`` rows.  No per-node Python work remains
    on the geometry path.
  * **k-NN** keeps best-first search (Hjaltason & Samet) over rows — the
    traversal order is what pins the I/O accounting — but child mindists are
    computed vectorized per expansion and leaf scans are one distance
    evaluation plus one ``argpartition`` merge.
  * Batched entry points (``window_query_batch`` / ``knn_query_batch``)
    execute many queries against one traversal, Flood-style: branch pages
    are visited (and charged) once per batch, leaf work is vectorized across
    the query batch, and k-NN prunes with vectorized mindists over the leaf
    table (one shared ``(L, d)`` view straight out of the node table).

I/O equivalence
---------------
Every node visit charges one buffered page read through the index's LRU
``PageStore``, and the LRU makes charges *order*-dependent.  The frontier
pass therefore only computes the visited set and the results; the page reads
are then replayed in exactly the depth-first order the object-graph engine
used (children expanded onto a stack, visited in reverse — see
``_charge_reads_dfs``), so ``IOStats`` stay bit-identical to the
object-graph scan engine.

This module is the PyTorch port's own copy of the JAX package's NumPy
engine (``repro/core/queries.py``), unchanged: it is the paper's engine,
the host oracle of the port and what the port's ``AMBI`` queries through.

AMBI's on-demand refinement mutates the table mid-traversal, so when a
``refiner`` is supplied the sequential row-at-a-time traversal runs instead
(the construction I/O it charges must interleave with the query's page reads
exactly as before); the ``refiner(row)`` hook refines an unrefined row in
place and returns False when the row is empty.
"""
from __future__ import annotations

import heapq
import itertools

import numpy as np

from .fmbi import Index
from .geometry import mbb_intersects, mindist_sq  # noqa: F401 — re-exported (legacy home)
from .nodetable import NodeTable, ragged_ranges
from .pagestore import IOStats


def _merge_topk(
    best_d: np.ndarray, best_r: np.ndarray,
    d2: np.ndarray, rows: np.ndarray, k: int,
):
    """Merge leaf candidates into the running top-k (one partition, no heap)."""
    d = np.concatenate([best_d, d2])
    r = np.concatenate([best_r, rows])
    if len(d) > k:
        sel = np.argpartition(d, k - 1)[:k]
        d, r = d[sel], r[sel]
    return d, r


class _TopKBuffer:
    """Preallocated top-k accumulator: one scratch pair reused across every
    leaf merge (and across queries in a batch) instead of per-leaf
    ``concatenate`` churn.  Selection is the same ``argpartition`` as
    :func:`_merge_topk`, so results and tie behaviour are identical."""

    __slots__ = ("k", "d", "r", "n")

    def __init__(self, k: int, max_leaf: int):
        self.k = k
        self.d = np.empty(k + max_leaf, dtype=np.float64)
        self.r = np.empty(k + max_leaf, dtype=np.int64)
        self.n = 0

    def reset(self) -> None:
        self.n = 0

    @property
    def kth(self) -> float:
        return float(self.d[: self.n].max()) if self.n == self.k else np.inf

    def merge(self, d2: np.ndarray, rows: np.ndarray) -> None:
        m = len(d2)
        self.d[self.n : self.n + m] = d2
        self.r[self.n : self.n + m] = rows
        n = self.n + m
        if n > self.k:
            sel = np.argpartition(self.d[:n], self.k - 1)[: self.k]
            self.d[: self.k] = self.d[sel]
            self.r[: self.k] = self.r[sel]
            n = self.k
        self.n = n

    def result(self) -> np.ndarray:
        order = np.argsort(self.d[: self.n], kind="stable")
        return self.r[: self.n][order]


# --------------------------------------------------------------------------
# I/O replay (the LRU makes read charges order-dependent)
# --------------------------------------------------------------------------
def _charge_reads_dfs(table: NodeTable, hit: np.ndarray, store) -> None:
    """Charge one page read per hit row in the object-graph engine's exact
    depth-first pop order (stack seeded with the root, children extended in
    list order, therefore visited in reverse).

    The hit set is downward-closed — a row qualifies only if its parent did —
    so filtering the table's cached full DFS order by the hit mask yields
    precisely the pruned traversal's read sequence: the extra rows a full
    walk visits under non-hit nodes are all non-hit themselves and the stack
    discipline keeps the hit rows' relative order unchanged."""
    dfs = table.dfs_order()
    read = store.read
    for p in table.page_id[dfs[hit[dfs]]]:
        read(int(p))


# --------------------------------------------------------------------------
# window query
# --------------------------------------------------------------------------
def window_query(
    index: Index,
    lo: np.ndarray,
    hi: np.ndarray,
    *,
    refiner=None,
) -> tuple[np.ndarray, IOStats]:
    """All dataset rows inside [lo, hi].  Returns (row indices, io delta).

    ``refiner(row)`` is AMBI's hook: called on qualifying unrefined rows to
    build their subtree on demand before traversal continues.
    """
    store = index.store
    before = store.stats.snapshot()
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    if refiner is not None:
        res = _window_adaptive(index, lo, hi, refiner)
        return res, store.stats.delta(before)
    t = index.table
    mlo, mhi = t.mbb_lo, t.mbb_hi
    hit = np.zeros(t.n_nodes, dtype=bool)
    frontier = np.zeros(1, dtype=np.int64)
    out: list[np.ndarray] = []
    while frontier.size:
        m = np.all(mlo[frontier] <= hi, axis=1) & np.all(
            mhi[frontier] >= lo, axis=1
        )
        rows = frontier[m]
        if rows.size == 0:
            break
        hit[rows] = True
        if t.unrefined[rows].any():
            raise RuntimeError("unrefined node reached without a refiner")
        leaf = t.leaf_start[rows] >= 0
        lrows = rows[leaf]
        if lrows.size:
            cand = t.perm[ragged_ranges(t.leaf_start[lrows], t.leaf_count[lrows])]
            pts = index.points[cand]
            mask = np.all((pts >= lo) & (pts <= hi), axis=1)
            if mask.any():
                out.append(cand[mask])
        brows = rows[~leaf]
        frontier = ragged_ranges(t.first_child[brows], t.child_count[brows])
    _charge_reads_dfs(t, hit, store)
    res = np.concatenate(out) if out else np.zeros(0, dtype=np.int64)
    return res, store.stats.delta(before)


def _window_adaptive(index: Index, lo, hi, refiner) -> np.ndarray:
    """Sequential row-DFS for refining traversals (order-faithful I/O)."""
    t = index.table
    store = index.store
    out: list[np.ndarray] = []
    stack = [0]
    while stack:
        r = stack.pop()
        if not (np.all(t.mbb_lo[r] <= hi) and np.all(t.mbb_hi[r] >= lo)):
            continue
        store.read(int(t.page_id[r]))
        if t.unrefined[r]:
            if refiner(r):
                stack.append(r)  # revisit: the row now holds the subtree
            continue
        if t.leaf_start[r] >= 0:
            cand = t.point_rows(r)
            pts = index.points[cand]
            mask = np.all((pts >= lo) & (pts <= hi), axis=1)
            if mask.any():
                out.append(cand[mask])
        else:
            stack.extend(t.children_of(r))
    return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)


def window_query_batch(
    index: Index,
    los: np.ndarray,
    his: np.ndarray,
    *,
    refiner=None,
) -> tuple[list[np.ndarray], IOStats]:
    """Execute ``Q`` window queries in one frontier traversal.

    Returns (per-query row-index arrays, io delta).  A node is visited — and
    its page read charged — once if *any* query in the batch intersects it,
    which is the batch's I/O amortization; leaf points are filtered against
    all active queries with a single broadcast comparison.  With a
    ``refiner`` the sequential traversal runs instead (see module docstring).
    """
    store = index.store
    before = store.stats.snapshot()
    los = np.atleast_2d(np.asarray(los, dtype=np.float64))
    his = np.atleast_2d(np.asarray(his, dtype=np.float64))
    nq = los.shape[0]
    if refiner is not None:
        res = _window_batch_adaptive(index, los, his, refiner)
        return res, store.stats.delta(before)
    t = index.table
    mlo, mhi = t.mbb_lo, t.mbb_hi
    hitmask = np.zeros(t.n_nodes, dtype=bool)
    frontier = np.zeros(1, dtype=np.int64)
    act = np.ones((1, nq), dtype=bool)
    # per query: which leaf rows qualify (filtered in one gather at the end,
    # so a leaf's points are only ever compared against the queries that
    # actually reach it — the object-graph engine's work, vectorized)
    pending: list[list[np.ndarray]] = [[] for _ in range(nq)]
    while frontier.size:
        hit = act & (
            np.all(mlo[frontier][:, None, :] <= his[None, :, :], axis=2)
            & np.all(mhi[frontier][:, None, :] >= los[None, :, :], axis=2)
        )  # (F, Q)
        any_hit = hit.any(axis=1)
        rows = frontier[any_hit]
        if rows.size == 0:
            break
        hit = hit[any_hit]
        hitmask[rows] = True
        if t.unrefined[rows].any():
            raise RuntimeError("unrefined node reached without a refiner")
        leaf = t.leaf_start[rows] >= 0
        lrows = rows[leaf]
        if lrows.size:
            lhit = hit[leaf]
            for qi in np.flatnonzero(lhit.any(axis=0)):
                pending[qi].append(lrows[lhit[:, qi]])
        brows = rows[~leaf]
        frontier = ragged_ranges(t.first_child[brows], t.child_count[brows])
        act = np.repeat(hit[~leaf], t.child_count[brows], axis=0)
    _charge_reads_dfs(t, hitmask, store)
    res = []
    for qi in range(nq):
        if not pending[qi]:
            res.append(np.zeros(0, dtype=np.int64))
            continue
        rows = np.concatenate(pending[qi])
        cand = t.perm[ragged_ranges(t.leaf_start[rows], t.leaf_count[rows])]
        pts = index.points[cand]
        mask = np.all((pts >= los[qi]) & (pts <= his[qi]), axis=1)
        res.append(cand[mask])
    return res, store.stats.delta(before)


def _window_batch_adaptive(index: Index, los, his, refiner):
    t = index.table
    store = index.store
    nq = los.shape[0]
    out: list[list[np.ndarray]] = [[] for _ in range(nq)]
    stack: list[tuple[int, np.ndarray]] = [(0, np.arange(nq))]
    while stack:
        r, qids = stack.pop()
        hit = np.all(t.mbb_lo[r] <= his[qids], axis=1) & np.all(
            t.mbb_hi[r] >= los[qids], axis=1
        )
        if not hit.any():
            continue
        qids = qids[hit]
        store.read(int(t.page_id[r]))
        if t.unrefined[r]:
            if refiner(r):
                stack.append((r, qids))
            continue
        if t.leaf_start[r] >= 0:
            cand = t.point_rows(r)
            pts = index.points[cand]
            inside = np.all(
                (pts[None, :, :] >= los[qids, None, :])
                & (pts[None, :, :] <= his[qids, None, :]),
                axis=2,
            )
            for qi, m in zip(qids, inside):
                if m.any():
                    out[qi].append(cand[m])
        else:
            stack.extend((c, qids) for c in t.children_of(r))
    return [np.concatenate(o) if o else np.zeros(0, dtype=np.int64) for o in out]


# --------------------------------------------------------------------------
# k-NN query (best-first)
# --------------------------------------------------------------------------
def knn_query(
    index: Index,
    q: np.ndarray,
    k: int,
    *,
    refiner=None,
) -> tuple[np.ndarray, IOStats]:
    """k nearest dataset rows to ``q``.  Returns (row indices, io delta).

    Best-first over table rows: the heap order (and therefore every page
    read) is identical to the object-graph engine; expanding a branch
    computes all child mindists in one vectorized pass.
    """
    store = index.store
    before = store.stats.snapshot()
    q = np.asarray(q, dtype=np.float64)
    t = index.table
    counter = itertools.count()  # tie-breaker for heap ordering
    heap: list = [(0.0, next(counter), 0)]
    best_d = np.full(0, np.inf)
    best_r = np.zeros(0, dtype=np.int64)
    while heap:
        dist, _, r = heapq.heappop(heap)
        kth = best_d.max() if len(best_d) == k else np.inf
        if dist > kth:
            break
        store.read(int(t.page_id[r]))
        if t.unrefined[r]:
            if refiner is None:
                raise RuntimeError("unrefined node reached without a refiner")
            if not refiner(r):
                continue
            md = mindist_sq(
                np.stack([t.mbb_lo[r], t.mbb_hi[r]]), q
            )
            heapq.heappush(heap, (md, next(counter), r))
            continue
        if t.leaf_start[r] >= 0:
            cand = t.point_rows(r)
            pts = index.points[cand]
            d2 = np.sum((pts - q) ** 2, axis=1)
            best_d, best_r = _merge_topk(best_d, best_r, d2, cand, k)
        else:
            kth = best_d.max() if len(best_d) == k else np.inf
            ch = np.arange(
                t.first_child[r], t.first_child[r] + t.child_count[r]
            )
            gap = np.maximum(t.mbb_lo[ch] - q, 0.0) + np.maximum(
                q - t.mbb_hi[ch], 0.0
            )
            mds = np.einsum("ij,ij->i", gap, gap)
            for c, md in zip(ch, mds):
                if md <= kth:
                    heapq.heappush(heap, (float(md), next(counter), int(c)))
    order = np.argsort(best_d, kind="stable")
    return best_r[order], store.stats.delta(before)


def knn_query_batch(
    index: Index,
    qs: np.ndarray,
    k: int,
) -> tuple[list[np.ndarray], IOStats]:
    """Execute ``Q`` k-NN queries against one leaf-table traversal.

    Branch pages are read once per batch (in the engine's depth-first
    order); the leaf boxes come straight out of the node table as shared
    ``(L, d)`` views — nothing is stacked per batch, let alone per query.
    Each query prunes at leaf granularity with one vectorized mindist pass,
    scanning leaves in ascending-mindist order until the running k-th
    distance certifies no unscanned leaf can compete (the best-first
    guarantee); the top-k accumulates in one preallocated buffer reused
    across leaves and queries.  Leaf page reads are charged per scan through
    the shared LRU buffer, so overlapping queries hit the buffer instead of
    re-reading.

    Unrefined (AMBI) rows are not supported here: a batch prunes with the
    full leaf table, which an on-demand build does not have yet — fully
    refine first or use per-query :func:`knn_query`.
    """
    store = index.store
    before = store.stats.snapshot()
    qs = np.atleast_2d(np.asarray(qs, dtype=np.float64))
    t = index.table
    if t.unrefined.any():
        raise RuntimeError("knn_query_batch requires a fully refined index")

    # one traversal: charge each branch page once, in depth-first pop order;
    # leaves keep that same order so mindist ties scan identically
    dfs = t.dfs_order()
    leaf_in_dfs = t.leaf_start[dfs] >= 0
    pid = t.page_id
    read = store.read
    for r in dfs[~leaf_in_dfs]:
        read(int(pid[r]))
    leaf_rows = dfs[leaf_in_dfs]
    leaf_lo = t.mbb_lo[leaf_rows]
    leaf_hi = t.mbb_hi[leaf_rows]
    starts = t.leaf_start[leaf_rows]
    counts = t.leaf_count[leaf_rows]

    topk = _TopKBuffer(k, int(counts.max()) if len(counts) else 1)
    results: list[np.ndarray] = []
    for q in qs:
        gap = np.maximum(leaf_lo - q, 0.0) + np.maximum(q - leaf_hi, 0.0)
        mind = np.sum(gap * gap, axis=1)  # (L,)
        order = np.argsort(mind, kind="stable")
        topk.reset()
        for li in order:
            if mind[li] > topk.kth:
                break
            read(int(pid[leaf_rows[li]]))
            cand = t.perm[starts[li] : starts[li] + counts[li]]
            pts = index.points[cand]
            d2 = np.sum((pts - q) ** 2, axis=1)
            topk.merge(d2, cand)
        results.append(topk.result())
    return results, store.stats.delta(before)


# --------------------------------------------------------------------------
# brute-force oracles (for tests)
# --------------------------------------------------------------------------
def window_oracle(points: np.ndarray, lo, hi) -> np.ndarray:
    mask = np.all((points >= np.asarray(lo)) & (points <= np.asarray(hi)), axis=1)
    return np.flatnonzero(mask)


def knn_oracle(points: np.ndarray, q, k: int) -> np.ndarray:
    d2 = np.sum((points - np.asarray(q)) ** 2, axis=1)
    return np.argsort(d2, kind="stable")[:k]
