"""Streaming ingest: a live LSM-tiered index over the scan-engine bulk loader.

The paper's thesis — linear-scan bulk loading is cheap enough to repeat —
makes the loader itself the natural *merge primitive* for a live index.
This module turns the one-shot FMBI into an LSM-style tiered structure:

  * **Point buffer.**  All coordinates live in one amortized-doubling array;
    a point's id is its row, forever.  Inserts append; nothing moves.
  * **Delta memtable.**  Recent inserts go to an in-memory delta: a small
    ``NodeTable`` rebuilt in place (``refine_subspace`` over the delta rows)
    every ``delta_index_every`` inserts, with the not-yet-indexed tail
    answered by brute force.  When the delta reaches ``delta_threshold``
    rows it is *flushed*: bulk-loaded into an immutable tier.
  * **Tiers.**  Immutable bulk-loaded ``NodeTable``s in size-tiered levels
    (``level = floor(log_ratio(size / delta_threshold))``).  After a flush,
    the two newest tiers merge while they sit on the same level, so sizes
    grow geometrically and each point is rewritten O(log n) times.
  * **Merging.**  A merge with no tombstoned input rows is a *fusion*:
    ``NodeTable.merged`` splices the two trees under a fresh root page —
    zero point movement, zero page rewrites.  With tombstones, the merge
    re-runs the scan-engine bulk loader over the live rows (charging a
    sequential re-read of the inputs' pages) and frees the retired tiers'
    pages back to the ``PageStore`` allocator.
  * **Tombstones.**  Deletes mark a bitmap; queries filter, and the marks
    are dropped when the rows they shadow are rewritten (flush or rebuild
    merge).  ``shadow`` counts tombstoned-but-still-physically-present
    rows — the k-NN over-fetch bound.

Queries fan out over (tiers..., delta, pending tail) and merge: window by
union (components are disjoint by construction), k-NN by a two-level top-k
merge with ``k + shadow`` per-component over-fetch and tombstone filtering.

``DeviceMirror`` maintains an append-only ``NodeTable`` image of the live
tiers for the device/serving path: tier attach appends the subtree,
fusion appends one branch row adopting copies of the two old roots, a
rebuild-merge neutralizes the retired rows (inverted MBBs, zero counts) —
rows are never removed, so ``DeviceTable.apply_delta`` uploads only the
new leaf blocks and the serving layer never re-exports from scratch.

This module is the PyTorch port's own copy of the JAX package's
``repro/core/streaming.py``, unchanged; it runs on the port's host modules,
and its ``.npz`` stream snapshots are the same format, so either package
loads the other's.
"""
from __future__ import annotations

import json

import numpy as np

from ..analysis import runtime as _san
from .fmbi import Node, refine_subspace
from .ioutil import atomic_output
from .nodetable import NodeTable
from .pagestore import PageStore, branch_capacity, leaf_capacity

STREAM_VERSION = 1

_TABLE_COLS = (
    "mbb_lo", "mbb_hi", "page_id", "first_child", "child_count",
    "leaf_start", "leaf_count", "raw_pages", "unrefined", "perm",
)


def _pack_table(payload: dict, prefix: str, t: NodeTable) -> None:
    for col in _TABLE_COLS:
        payload[prefix + col] = getattr(t, col)


def _unpack_table(z, prefix: str, dim: int) -> NodeTable:
    n = len(z[prefix + "page_id"])
    n_perm = len(z[prefix + "perm"])
    t = NodeTable(dim, node_capacity=n + n // 8 + 16,
                  perm_capacity=n_perm + n_perm // 8 + 16)
    t._n = n
    t._np = n_perm
    t._mbb_lo[:n] = z[prefix + "mbb_lo"]
    t._mbb_hi[:n] = z[prefix + "mbb_hi"]
    t._page_id[:n] = z[prefix + "page_id"]
    t._first_child[:n] = z[prefix + "first_child"]
    t._child_count[:n] = z[prefix + "child_count"]
    t._leaf_start[:n] = z[prefix + "leaf_start"]
    t._leaf_count[:n] = z[prefix + "leaf_count"]
    t._raw_pages[:n] = z[prefix + "raw_pages"]
    t._unrefined[:n] = z[prefix + "unrefined"]
    t._perm[:n_perm] = z[prefix + "perm"]
    return t


class _TierView:
    """Duck-typed ``Index`` over the shared streaming point buffer — the
    NumPy query engines only touch ``table`` / ``store`` / ``points``."""

    __slots__ = ("table", "store", "points")

    def __init__(self, table: NodeTable, store: PageStore, points: np.ndarray):
        self.table = table
        self.store = store
        self.points = points


class Tier:
    """One immutable bulk-loaded component.

    ``rows`` are the global point ids physically present in ``table``
    (including rows tombstoned *after* the tier was built); ``fused`` marks
    tiers produced by structural fusion rather than a fresh bulk load.
    """

    __slots__ = ("tid", "rows", "table", "fused")

    def __init__(self, tid: int, rows: np.ndarray, table: NodeTable,
                 fused: bool = False):
        self.tid = int(tid)
        self.rows = rows
        self.table = table
        self.fused = bool(fused)

    def __len__(self) -> int:
        return len(self.rows)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Tier(tid={self.tid}, n={len(self.rows)}, fused={self.fused})"


class StreamingIndex:
    """A live LSM-tiered multidimensional index (host authority).

    Thread-compatibility: not internally locked — the serving layer
    serializes writers through its ``TableLock``.
    """

    def __init__(self, points, *, store=None, buffer_pages=256,
                 delta_threshold=2048, delta_index_every=256, size_ratio=4,
                 base_external=False, build_base=True):
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
        if pts.ndim != 2:
            raise ValueError("points must be (n, d)")
        n, d = pts.shape
        if d < 1:
            raise ValueError("points must have at least one dimension")
        self.dim = d
        self.leaf_cap = leaf_capacity(d)
        self.branch_cap = branch_capacity(d)
        self.store = store if store is not None else PageStore(buffer_pages)
        self.delta_threshold = int(delta_threshold)
        self.delta_index_every = int(delta_index_every)
        self.size_ratio = max(int(size_ratio), 2)
        if self.delta_threshold < 1 or self.delta_index_every < 1:
            raise ValueError("thresholds must be positive")

        cap = max(n, 1024)
        self._pts = np.empty((cap, d), dtype=np.float64)
        self._pts[:n] = pts
        self._tomb = np.zeros(cap, dtype=bool)
        self._n = n

        self._delta = np.empty(self.delta_threshold + 16, dtype=np.int64)
        self._delta_n = 0
        self._delta_indexed = 0
        self._delta_table: NodeTable | None = None

        self.tiers: list[Tier] = []
        self._next_tid = 0
        self._shadow = 0

        # base handling: ``base_external`` means rows [0, base_n) live in an
        # external structure (the adaptive server's AMBI) — this index only
        # owns the overlay and never tiers them.
        self.base_external = bool(base_external)
        self.base_n = n if self.base_external else 0
        if n and not self.base_external and build_base:
            self.store.read_run(-(-n // self.leaf_cap))  # boot scan of the data
            table = self._build_table(np.arange(n, dtype=np.int64))
            self.tiers.append(Tier(self._alloc_tid(), np.arange(n, dtype=np.int64), table))

        # counters (bench + tests)
        self.inserted = 0
        self.deleted = 0
        self.flushes = 0
        self.merges = 0
        self.fusions = 0
        self.delta_rebuilds = 0
        self.point_reallocs = 0

        # structural event log the device mirror consumes
        self.track_events = False
        self._events: list[tuple] = []

    # -- construction ------------------------------------------------------
    @classmethod
    def from_index(cls, index, **kw):
        """Adopt a built ``Index`` (its table becomes tier 0, its store the
        shared substrate) without re-loading anything."""
        self = cls(index.points, store=index.store, build_base=False, **kw)
        rows = np.arange(len(index.points), dtype=np.int64)
        self.tiers.append(Tier(self._alloc_tid(), rows, index.table))
        return self

    def _alloc_tid(self) -> int:
        t = self._next_tid
        self._next_tid += 1
        return t

    # -- views -------------------------------------------------------------
    @property
    def points(self) -> np.ndarray:
        """Live view of the point buffer (row == id)."""
        return self._pts[:self._n]

    @property
    def n_ids(self) -> int:
        return self._n

    @property
    def n_live(self) -> int:
        return self._n - int(self._tomb[:self._n].sum())

    @property
    def shadow(self) -> int:
        """Tombstoned ids still physically present in some component."""
        return self._shadow

    def live_mask(self) -> np.ndarray:
        return ~self._tomb[:self._n]

    def live_ids(self) -> np.ndarray:
        return np.flatnonzero(~self._tomb[:self._n])

    def filter_live(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        if len(ids) == 0:
            return ids
        return ids[~self._tomb[ids]]

    def delta_live_rows(self) -> np.ndarray:
        """Live ids currently held only by the delta/pending components
        (i.e. not in any tier) — the serving layer unions these host-side."""
        rows = self._delta[:self._delta_n]
        return rows[~self._tomb[rows]]

    # -- ingest ------------------------------------------------------------
    def _ensure_points(self, need: int) -> None:
        cap = len(self._pts)
        if need <= cap:
            return
        new = max(need, 2 * cap)
        pts = np.empty((new, self.dim), dtype=np.float64)
        pts[:self._n] = self._pts[:self._n]
        tomb = np.zeros(new, dtype=bool)
        tomb[:self._n] = self._tomb[:self._n]
        self._pts, self._tomb = pts, tomb
        self.point_reallocs += 1

    def insert(self, pts) -> np.ndarray:
        """Append points; returns their assigned ids (buffer rows)."""
        _san.check_write(self, "insert")
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
        if pts.shape[1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {pts.shape[1]}")
        q = len(pts)
        if q == 0:
            return np.empty(0, dtype=np.int64)
        self._ensure_points(self._n + q)
        ids = np.arange(self._n, self._n + q, dtype=np.int64)
        self._pts[self._n:self._n + q] = pts
        self._n += q
        self.inserted += q
        if self._delta_n + q > len(self._delta):
            grown = np.empty(max(self._delta_n + q, 2 * len(self._delta)),
                             dtype=np.int64)
            grown[:self._delta_n] = self._delta[:self._delta_n]
            self._delta = grown
        self._delta[self._delta_n:self._delta_n + q] = ids
        self._delta_n += q
        if self._delta_n >= self.delta_threshold:
            self._flush()
        elif self._delta_n - self._delta_indexed >= self.delta_index_every:
            self._reindex_delta()
        return ids

    def delete(self, ids) -> int:
        """Tombstone ids; returns how many were newly deleted."""
        _san.check_write(self, "delete")
        ids = np.unique(np.asarray(ids, dtype=np.int64).ravel())
        if len(ids) == 0:
            return 0
        if ids[0] < 0 or ids[-1] >= self._n:
            raise IndexError("delete id out of range")
        fresh = ids[~self._tomb[ids]]
        self._tomb[fresh] = True
        self._shadow += len(fresh)
        self.deleted += len(fresh)
        return len(fresh)

    # -- structure maintenance --------------------------------------------
    def _emit(self, *ev) -> None:
        if self.track_events:
            self._events.append(ev)

    def drain_events(self) -> list[tuple]:
        evs, self._events = self._events, []
        return evs

    def _build_table(self, rows: np.ndarray) -> NodeTable:
        """Bulk-load ``rows`` of the shared buffer into a fresh NodeTable
        (the scan-engine loader, charging its writes to the shared store)."""
        entries = refine_subspace(self.points, rows, self.leaf_cap,
                                  self.branch_cap, self.store)
        if len(entries) == 1:
            root = entries[0]
        else:
            lo = np.min([e.mbb[0] for e in entries], axis=0)
            hi = np.max([e.mbb[1] for e in entries], axis=0)
            page = self.store.alloc()
            self.store.write(page)
            root = Node(mbb=np.stack([lo, hi]), page_id=page, children=entries)
        return NodeTable.from_tree(root, self.dim, n_points_hint=len(rows))

    def _reindex_delta(self) -> None:
        if self._delta_table is not None:
            self.store.free_pages(self._delta_table.page_id)
        rows = self._delta[:self._delta_n].copy()
        # tombstoned delta rows stay physically indexed (queries filter);
        # they are dropped for good at flush time
        self._delta_table = self._build_table(rows)
        self._delta_indexed = self._delta_n
        self.delta_rebuilds += 1

    def _flush(self) -> None:
        rows = self._delta[:self._delta_n].copy()
        if self._delta_table is not None:
            self.store.free_pages(self._delta_table.page_id)
            self._delta_table = None
        self._delta_n = 0
        self._delta_indexed = 0
        dead = self._tomb[rows]
        live = rows[~dead]
        self._shadow -= int(dead.sum())
        if len(live) == 0:
            return
        table = self._build_table(live)
        tier = Tier(self._alloc_tid(), live, table)
        self.tiers.append(tier)
        self.flushes += 1
        self._emit("attach", tier)
        self._maybe_merge()

    def _level(self, size: int) -> int:
        if size <= self.delta_threshold:
            return 0
        return int(np.log(size / self.delta_threshold) // np.log(self.size_ratio))

    def _maybe_merge(self) -> None:
        # size-tiered policy: merge the two newest tiers while they occupy
        # the same level, so merges cascade geometrically (each id is
        # rewritten O(log n) times) instead of re-merging the big tier on
        # every flush (the quadratic failure mode).
        while len(self.tiers) >= 2:
            a, b = self.tiers[-2], self.tiers[-1]
            if self._level(len(a)) > self._level(len(b)):
                break
            self._merge_last_two()

    def _merge_last_two(self) -> None:
        b = self.tiers.pop()
        a = self.tiers.pop()
        rows = np.concatenate([a.rows, b.rows])
        dead = self._tomb[rows]
        ndead = int(dead.sum())
        if ndead == 0:
            # fusion: splice the two trees under a fresh root page — no
            # point movement, the constituent pages are reused verbatim
            root_page = self.store.alloc()
            self.store.write(root_page)
            ident = np.arange(self._n, dtype=np.int64)
            table = NodeTable.merged([a.table, b.table], [ident, ident],
                                     [0, 0], root_page)
            tier = Tier(self._alloc_tid(), rows, table, fused=True)
            self.fusions += 1
            self._emit("merge", (a, b), tier, True)
        else:
            live = rows[~dead]
            self._shadow -= ndead
            # the merge is a fresh scan-engine bulk load: charge a
            # sequential re-read of both inputs, then retire their pages
            in_pages = (len(np.unique(a.table.page_id))
                        + len(np.unique(b.table.page_id)))
            self.store.read_run(in_pages)
            tier = None
            if len(live):
                table = self._build_table(live)
                tier = Tier(self._alloc_tid(), live, table)
            self.store.free_pages(a.table.page_id)
            self.store.free_pages(b.table.page_id)
            self.merges += 1
            self._emit("merge", (a, b), tier, False)
        if tier is not None:
            self.tiers.append(tier)

    # -- queries (host authority) -----------------------------------------
    def _components(self) -> list[_TierView]:
        pts = self.points
        views = [_TierView(t.table, self.store, pts) for t in self.tiers]
        if self._delta_table is not None:
            views.append(_TierView(self._delta_table, self.store, pts))
        return views

    def _pending_rows(self) -> np.ndarray:
        return self._delta[self._delta_indexed:self._delta_n]

    def window(self, los, his) -> list[np.ndarray]:
        from .queries import window_query_batch

        los = np.atleast_2d(np.asarray(los, dtype=np.float64))
        his = np.atleast_2d(np.asarray(his, dtype=np.float64))
        nq = len(los)
        parts: list[list[np.ndarray]] = [[] for _ in range(nq)]
        for view in self._components():
            res, _ = window_query_batch(view, los, his)
            for i, ids in enumerate(res):
                parts[i].append(ids)
        pend = self.filter_live(self._pending_rows())
        if len(pend):
            p = self.points[pend]
            inside = ((p[None, :, :] >= los[:, None, :])
                      & (p[None, :, :] <= his[:, None, :])).all(axis=2)
            for i in range(nq):
                parts[i].append(pend[inside[i]])
        out = []
        for i in range(nq):
            ids = (np.concatenate(parts[i]) if parts[i]
                   else np.empty(0, dtype=np.int64))
            out.append(np.sort(self.filter_live(ids)))
        return out

    def knn(self, qs, k: int) -> list[np.ndarray]:
        from .queries import knn_query_batch

        qs = np.atleast_2d(np.asarray(qs, dtype=np.float64))
        nq = len(qs)
        k = int(k)
        # over-fetch: each component's top-(k+shadow) is guaranteed to
        # contain its k best *live* rows, whatever the tombstones hit
        k_eff = k + self._shadow
        cand: list[list[np.ndarray]] = [[] for _ in range(nq)]
        for view in self._components():
            res, _ = knn_query_batch(view, qs, k_eff)
            for i, ids in enumerate(res):
                cand[i].append(ids)
        pend = self.filter_live(self._pending_rows())
        out = []
        for i in range(nq):
            pool = cand[i] + ([pend] if len(pend) else [])
            ids = (np.unique(np.concatenate(pool)) if pool
                   else np.empty(0, dtype=np.int64))
            ids = self.filter_live(ids)
            d2 = np.sum((self.points[ids] - qs[i]) ** 2, axis=1)
            ids = ids[np.lexsort((ids, d2))[:k]]
            out.append(ids)
        return out

    # -- persistence -------------------------------------------------------
    def save(self, path, extra: dict | None = None) -> None:
        payload: dict = {
            "stream_version": np.int64(STREAM_VERSION),
            "dim": np.int64(self.dim),
            "n": np.int64(self._n),
            "points": self.points,
            "tomb": self._tomb[:self._n],
            "shadow": np.int64(self._shadow),
            "base_external": np.int64(self.base_external),
            "base_n": np.int64(self.base_n),
            "next_tid": np.int64(self._next_tid),
            "delta_threshold": np.int64(self.delta_threshold),
            "delta_index_every": np.int64(self.delta_index_every),
            "size_ratio": np.int64(self.size_ratio),
            "delta_rows": self._delta[:self._delta_n].copy(),
            "delta_indexed": np.int64(self._delta_indexed),
            "store_state": np.str_(json.dumps(self.store.state_dict())),
            "n_tiers": np.int64(len(self.tiers)),
        }
        for i, t in enumerate(self.tiers):
            payload[f"tier{i}_tid"] = np.int64(t.tid)
            payload[f"tier{i}_fused"] = np.int64(t.fused)
            payload[f"tier{i}_rows"] = t.rows
            _pack_table(payload, f"tier{i}_", t.table)
        if self._delta_table is not None:
            _pack_table(payload, "dtab_", self._delta_table)
        for key, val in (extra or {}).items():
            payload[f"meta_{key}"] = np.asarray(val)
        with atomic_output(path) as tmp:
            np.savez_compressed(tmp, **payload)

    @classmethod
    def load(cls, path):  # analysis: single-threaded(snapshot restore builds an unpublished instance)
        """Returns ``(stream, meta)`` where meta holds the ``extra`` dict."""
        with np.load(path, allow_pickle=False) as z:
            if int(z["stream_version"]) != STREAM_VERSION:
                raise ValueError("unknown stream snapshot version")
            dim = int(z["dim"])
            store = PageStore(1)
            store.load_state(json.loads(str(z["store_state"])))
            self = cls(z["points"], store=store, build_base=False,
                       delta_threshold=int(z["delta_threshold"]),
                       delta_index_every=int(z["delta_index_every"]),
                       size_ratio=int(z["size_ratio"]),
                       base_external=bool(int(z["base_external"])))
            self.base_n = int(z["base_n"])
            n = int(z["n"])
            self._tomb[:n] = z["tomb"]
            self._shadow = int(z["shadow"])
            self._next_tid = int(z["next_tid"])
            for i in range(int(z["n_tiers"])):
                table = _unpack_table(z, f"tier{i}_", dim)
                self.tiers.append(Tier(int(z[f"tier{i}_tid"]),
                                       z[f"tier{i}_rows"], table,
                                       fused=bool(int(z[f"tier{i}_fused"]))))
            drows = z["delta_rows"]
            self._delta[:len(drows)] = drows
            self._delta_n = len(drows)
            self._delta_indexed = int(z["delta_indexed"])
            if "dtab_page_id" in z.files:
                self._delta_table = _unpack_table(z, "dtab_", dim)
            meta = {k[len("meta_"):]: z[k] for k in z.files
                    if k.startswith("meta_")}
        return self, meta

    @staticmethod
    def is_stream_snapshot(path) -> bool:
        try:
            with np.load(path, allow_pickle=False) as z:
                return "stream_version" in z.files
        except (OSError, ValueError):
            return False


class DeviceMirror:
    """Append-only ``NodeTable`` image of a stream's live tiers.

    The serving layer exports *this* table to the device.  The contract
    that makes delta-only refresh possible: **rows are never removed**.

      * tier attach  -> ``append_subtree`` (new rows at the end)
      * fusion       -> copies of the two old roots + one new branch row
        adopting them; the old root rows are neutralized
      * rebuild-merge-> all rows of the retired tiers neutralized
        (inverted MBB, zero leaf count — invisible to window traversal
        and infinitely far for the k-NN leaf-table pruning), then the
        merged tier attaches like any other
      * every sync ends by rebuilding the root's child block: fresh
        copies of the live tier roots, adopted by row 0

    ``sync`` applies the stream's structural event log and returns the
    plan-surgery summary the sharded path needs (row remaps for moved
    root copies, retired spans, new roots to place).  Not thread-safe —
    callers serialize through the server's ``TableLock``.
    """

    def __init__(self, stream: StreamingIndex):
        if not stream.tiers:
            raise ValueError("device mirror needs at least one tier")
        self.stream = stream
        t = NodeTable(stream.dim, node_capacity=64, perm_capacity=64)
        root_page = stream.store.alloc()
        stream.store.write(root_page)
        t._grow_nodes(1)
        t._page_id[0] = root_page
        t._leaf_start[0] = -1
        self.table = t
        self.spans: dict[int, list[tuple[int, int]]] = {}
        self.root_rows: dict[int, int] = {}
        self._remap: dict[int, int] = {}
        self._retired: list[tuple[int, int]] = []
        stream.track_events = True
        stream.drain_events()  # discard pre-mirror history
        for tier in stream.tiers:
            self._attach(tier)
        self._rebuild_root()
        self._remap = {}
        self._retired = []

    # -- structural ops ----------------------------------------------------
    def _attach(self, tier: Tier) -> int:
        base = self.table.append_subtree(tier.table)
        self.spans[tier.tid] = [(base, base + tier.table.n_nodes)]
        self.root_rows[tier.tid] = base
        return base

    def _fuse(self, a: Tier, b: Tier, new: Tier) -> None:
        ra = self.root_rows.pop(a.tid)
        rb = self.root_rows.pop(b.tid)
        blk = self.table.append_row_copies(np.array([ra, rb], dtype=np.int64))
        self.table.neutralize_rows(np.array([ra, rb], dtype=np.int64))
        parent = self.table.append_branch(blk, 2, int(new.table.page_id[0]))
        self._remap[ra] = blk
        self._remap[rb] = blk + 1
        self.spans[new.tid] = (self.spans.pop(a.tid) + self.spans.pop(b.tid)
                               + [(blk, parent + 1)])
        self.root_rows[new.tid] = parent

    def _retire(self, tier: Tier) -> None:
        for lo, hi in self.spans.pop(tier.tid):
            self.table.neutralize_rows(np.arange(lo, hi, dtype=np.int64))
            self._retired.append((lo, hi))
        self.root_rows.pop(tier.tid, None)

    def _rebuild_root(self) -> None:
        tids = sorted(self.root_rows)
        if not tids:
            self.table.set_root_children(0, 0)
            return
        old = np.array([self.root_rows[t] for t in tids], dtype=np.int64)
        blk = self.table.append_row_copies(old)
        self.table.neutralize_rows(old)
        for j, tid in enumerate(tids):
            self._remap[int(old[j])] = blk + j
            self.root_rows[tid] = blk + j
            self.spans[tid].append((blk + j, blk + j + 1))
        self.table.set_root_children(blk, len(tids))

    def _resolve(self, row: int) -> int:
        while row in self._remap:
            row = self._remap[row]
        return row

    def sync(self):
        """Apply pending stream events.  Returns ``None`` when nothing
        changed, else a dict:

          * ``remap``        — resolved old-row -> new-row map for root
            copies whose *content is identical* (no re-upload needed)
          * ``retired``      — row spans neutralized this sync
          * ``add_rows``     — mirror rows of newly attached subspaces
            that no shard plan covers yet
        """
        _san.check_write(self, "sync")
        evs = self.stream.drain_events()
        if not evs:
            return None
        self._remap = {}
        self._retired = []
        pending: dict[int, int] = {}
        for ev in evs:
            if ev[0] == "attach":
                tier = ev[1]
                pending[tier.tid] = self._attach(tier)
            else:
                (a, b), new, fused = ev[1], ev[2], ev[3]
                if fused:
                    # constituents stay covered by their (remapped) plan
                    # entries; a pending constituent's row resolves through
                    # the remap to its copy under the new parent
                    self._fuse(a, b, new)
                else:
                    self._retire(a)
                    self._retire(b)
                    pending.pop(a.tid, None)
                    pending.pop(b.tid, None)
                    if new is not None:
                        pending[new.tid] = self._attach(new)
        self._rebuild_root()
        remap = {old: self._resolve(old) for old in list(self._remap)}
        add_rows = sorted({self._resolve(r) for r in pending.values()})
        info = {"remap": remap, "retired": list(self._retired),
                "add_rows": add_rows}
        self._remap = {}
        self._retired = []
        return info
