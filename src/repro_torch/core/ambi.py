"""AMBI: Adaptive Multidimensional Bulkloaded Index (paper Section 4).

The index is built on demand while queries are processed.  The whole dataset
starts as a single *unrefined* root node; refining an unrefined node runs the
adaptive analogue of FMBI's Steps 1-4 (Section 4.1):

  * Step 2 keeps a max-heap of active subspaces ordered by their distance to
    the current query and flushes the farthest first, so qualified subspaces
    stay in memory;
  * a qualified subspace holding >= C_B pages is *split* (minor SplitTree of
    its in-memory pages) instead of flushed — its children join the heap;
  * after distribution only the active subspaces are refined (Algorithm 1,
    free: their pages are in memory); inactive subspaces become unrefined
    nodes that later queries refine on demand (sparse -> Algorithm 1 after
    re-reading their pages, dense -> recursive adaptive build);
  * Algorithm 2 merging includes unrefined subspaces — a sparse subspace of
    P pages always yields exactly P leaf entries, so its entry count is known
    before refinement (paper Section 4.1).

The node set AMBI converges to is independent of the query order; with
queries covering the whole space it coincides with FMBI.

Scan engine
-----------
The adaptive distribution is chunk-batched: each streamed page is grouped
with one stable argsort, per-subspace counts and bounding boxes are updated
with ``reduceat`` segment reductions, and the grow/flush/split bookkeeping
runs only for the few subspaces whose in-memory point count actually crosses
a page boundary.  Subspace MBBs (the max-heap keys) are maintained
incrementally instead of being recomputed from every buffered point at each
victim selection, and the final per-subspace row lists come from one global
stable argsort rather than per-page list appends.  One deliberate
difference from the strictly sequential formulation: all of a page's counts
and MBB updates are applied before that page's flush decisions run, so a
decision sees the page's full contents even for subspaces later in the
page's group order — the flush policy itself is unchanged.

This module is the PyTorch port's own copy of the JAX package's
``repro/core/ambi.py``, unchanged; it runs on the port's host modules.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .fmbi import Index, Node, merge_branches, refine_subspace
from .geometry import mindist_box_sq, mindist_sq
from .nodetable import NodeTable, NodeView
from .pagestore import PageStore, branch_capacity, leaf_capacity
from .queries import knn_query, window_query
from .splittree import build_group_median_tree, mbb_of


class AMBI:
    def __init__(
        self,
        points: np.ndarray,
        buffer_pages: int,
        store: Optional[PageStore] = None,
        rng: Optional[np.random.Generator] = None,
    ):
        self.points = points
        self.M = buffer_pages
        self.store = store or PageStore(buffer_pages)
        self.rng = rng or np.random.default_rng(0)
        n, d = points.shape
        self.d = d
        self.c_l = leaf_capacity(d)
        self.c_b = branch_capacity(d)
        root_page = self.store.alloc()
        self.table = NodeTable.single_unrefined(
            mbb=mbb_of(points) if n else np.zeros((2, d)),
            page_id=root_page,
            raw_pages=-(-n // self.c_l),
            rows=np.arange(n),
        )
        self.index = Index(self.table, d, self.c_l, self.c_b, self.store, points)

    @property
    def root(self) -> NodeView:
        return self.index.root

    # -- durable adaptive state --------------------------------------------
    # Grafting is deterministic given (points, M, rng state, store state):
    # ``_adaptive_build`` draws only from ``self.rng`` and page ids only
    # from ``self.store``.  Capturing both alongside the table snapshot is
    # what lets crash recovery *replay* the journaled cold queries and land
    # on the bit-identical table.
    def state_meta(self) -> str:
        """JSON blob of everything beyond the table that refinement
        consumes: the buffer size, the rng bit-generator state, and the
        page store (allocator + IOStats + LRU residency)."""
        import json

        return json.dumps(
            {
                "M": int(self.M),
                "rng": self.rng.bit_generator.state,
                "store": self.store.state_dict(),
            }
        )

    @classmethod
    def from_table_state(
        cls, points: np.ndarray, table: NodeTable, meta: str
    ) -> "AMBI":
        """Rebuild a live AMBI around an existing (snapshot-loaded) table
        and a :meth:`state_meta` blob — the recovery boot path."""
        import json

        state = json.loads(meta)
        self = cls.__new__(cls)
        self.points = points
        self.M = int(state["M"])
        self.store = PageStore(self.M)
        self.store.load_state(state["store"])
        self.rng = np.random.default_rng(0)
        self.rng.bit_generator.state = state["rng"]
        n, d = points.shape
        self.d = d
        self.c_l = leaf_capacity(d)
        self.c_b = branch_capacity(d)
        self.table = table
        self.index = Index(table, d, self.c_l, self.c_b, self.store, points)
        return self

    # -- public query API --------------------------------------------------
    def window(self, lo, hi):
        lo = np.asarray(lo, dtype=np.float64)
        hi = np.asarray(hi, dtype=np.float64)
        return window_query(
            self.index, lo, hi, refiner=self.window_refiner(lo, hi)
        )

    def knn(self, q, k: int):
        q = np.asarray(q, dtype=np.float64)
        return knn_query(self.index, q, k, refiner=self.knn_refiner(q))

    # -- refiners: the query context is bound explicitly, never held as
    # instance state (a refinement triggered outside a query — the serving
    # loop's case — must flush against *that* query, not the last one)
    def window_refiner(self, lo, hi) -> Callable[[int], bool]:
        """Row refiner whose flush policy keys on distance to [lo, hi]."""
        lo = np.asarray(lo, dtype=np.float64)
        hi = np.asarray(hi, dtype=np.float64)
        return lambda row: self._refine(
            row, lambda mbb: mindist_box_sq(mbb, lo, hi)
        )

    def knn_refiner(self, q) -> Callable[[int], bool]:
        """Row refiner whose flush policy keys on distance to point ``q``."""
        q = np.asarray(q, dtype=np.float64)
        return lambda row: self._refine(row, lambda mbb: mindist_sq(mbb, q))

    def is_fully_refined(self) -> bool:
        return not bool(self.table.unrefined.any())

    # -- refinement --------------------------------------------------------
    def _refine(
        self, row: int, query_dist: Callable[[np.ndarray], float]
    ) -> bool:
        """Refine unrefined table ``row`` in place (the construction
        machinery assembles a transient ``Node`` subtree which is grafted
        into the table); returns False when the row holds no points.
        ``query_dist`` maps a subspace MBB to its distance from the query
        that triggered refinement (the adaptive build's max-heap key)."""
        idx = self.table.point_rows(row)
        if len(idx) == 0:
            return False
        idx = idx.copy()  # graft appends to perm; detach the live view
        pages = -(-len(idx) // self.c_l)
        if pages <= self.M:
            # sparse: reload its pages and refine with Algorithm 1
            self.store.read_run(int(self.table.raw_pages[row]))
            entries = refine_subspace(
                self.points, idx, self.c_l, self.c_b, self.store
            )
        else:
            entries = self._adaptive_build(idx, query_dist)
        self.table.graft(row, entries)
        return True

    def _adaptive_build(
        self, idx: np.ndarray, query_dist: Callable[[np.ndarray], float]
    ) -> list[Node]:
        """Adaptive Steps 1-4 scoped to a dense unrefined row; returns its
        root entry list."""
        points, store, c_l, c_b, M = (
            self.points,
            self.store,
            self.c_l,
            self.c_b,
            self.M,
        )
        n = len(idx)
        p_total = -(-n // c_l)
        alpha = max(M // c_b, 1)

        # Step 1: sample alpha*C_B pages, build the Major SplitTree
        sample_pages = min(alpha * c_b, p_total)
        store.read_run(sample_pages)
        need = min(sample_pages * c_l, n)
        perm = self.rng.permutation(n)
        samp_local = np.sort(perm[:need])
        rest_local = np.sort(perm[need:])
        n_groups = max(need // (alpha * c_l), 1)
        trim = n_groups * alpha * c_l
        samp_use, samp_extra = samp_local[:trim], samp_local[trim:]
        mst, _, samp_assign = build_group_median_tree(
            points[idx[samp_use]], n_groups, alpha, c_l
        )

        # live routing forest state, array-form.  Subspace i: point count,
        # disk/memory pages, active flag, and an incrementally maintained MBB
        # (identical to the min/max over its buffered points, which the
        # scalar formulation recomputed at every victim selection).
        count = np.zeros(n_groups, dtype=np.int64)
        disk = np.zeros(n_groups, dtype=np.int64)
        mem = np.full(n_groups, alpha, dtype=np.int64)
        active = np.ones(n_groups, dtype=bool)
        mbb_lo = np.full((n_groups, self.d), np.inf)
        mbb_hi = np.full((n_groups, self.d), -np.inf)
        refine_map: dict[int, tuple] = {}  # sub id -> (tree, child sub ids)

        # arrival log: per streamed page, the rows (group-sorted) and their
        # subspace assignment; the Step-3 row lists fall out of one global
        # stable argsort at the end
        all_rows: list[np.ndarray] = []
        all_assign: list[np.ndarray] = []

        def grow_subs(k: int) -> list[int]:
            nonlocal count, disk, mem, active, mbb_lo, mbb_hi
            first = len(count)
            count = np.concatenate([count, np.zeros(k, np.int64)])
            disk = np.concatenate([disk, np.zeros(k, np.int64)])
            mem = np.concatenate([mem, np.zeros(k, np.int64)])
            active = np.concatenate([active, np.ones(k, bool)])
            mbb_lo = np.vstack([mbb_lo, np.full((k, self.d), np.inf)])
            mbb_hi = np.vstack([mbb_hi, np.full((k, self.d), -np.inf)])
            return list(range(first, first + k))

        def route(rows: np.ndarray) -> np.ndarray:
            out = mst.route(points[rows])
            pending = {s for s in np.unique(out) if int(s) in refine_map}
            while pending:
                s = pending.pop()
                tree, kids = refine_map[int(s)]
                sel = out == s
                sub_assign = tree.route(points[rows[sel]])
                out[sel] = np.asarray(kids, dtype=np.int32)[sub_assign]
                pending |= {
                    t for t in np.unique(out[sel]) if int(t) in refine_map
                }
            return out

        def ingest(rows: np.ndarray, a: np.ndarray):
            """Group-by + segment min/max updates for one streamed page.
            Returns the page's (sorted) group ids."""
            order = np.argsort(a, kind="stable")
            ra, aa = rows[order], a[order]
            uniq, starts = np.unique(aa, return_index=True)
            seg = points[ra]
            mbb_lo[uniq] = np.minimum(
                mbb_lo[uniq], np.minimum.reduceat(seg, starts, axis=0)
            )
            mbb_hi[uniq] = np.maximum(
                mbb_hi[uniq], np.maximum.reduceat(seg, starts, axis=0)
            )
            count[uniq] += np.diff(np.append(starts, len(aa)))
            all_rows.append(ra)
            all_assign.append(aa.astype(np.int32))
            return uniq

        def qdist(i: int) -> float:
            if count[i] == 0:
                return np.inf
            return query_dist(np.stack([mbb_lo[i], mbb_hi[i]]))

        def mem_used() -> int:
            return int(mem.sum())

        def materialize(si: int) -> np.ndarray:
            parts = [r[a == si] for r, a in zip(all_rows, all_assign)]
            parts = [p for p in parts if len(p)]
            return (
                np.concatenate(parts) if parts else np.zeros(0, np.int64)
            )

        def split_sub(si: int) -> None:
            """Qualified & large: replace sub by <= C_B minor-tree children."""
            rows = materialize(si)
            beta = max(len(rows) // (c_l * c_b), 1)
            groups = min(c_b, max(len(rows) // (beta * c_l), 2))
            trim2 = groups * beta * c_l
            tree, _, assign2 = build_group_median_tree(
                points[rows[:trim2]], groups, beta, c_l
            )
            kid_ids = grow_subs(groups)
            kid_arr = np.asarray(kid_ids, dtype=np.int32)
            leftover = rows[trim2:]
            la = (
                tree.route(points[leftover])
                if len(leftover)
                else np.zeros(0, np.int32)
            )
            new_assign = np.concatenate([kid_arr[assign2], kid_arr[la]])
            # rewrite the arrival log: si's rows now belong to its children
            pos = 0
            for arr_a in all_assign:
                msk = arr_a == si
                c = int(msk.sum())
                if c:
                    arr_a[msk] = new_assign[pos : pos + c]
                    pos += c
            # children state: counts/MBBs over their actual rows
            kc = np.bincount(
                new_assign - kid_ids[0], minlength=groups
            ).astype(np.int64)
            count[kid_ids] = kc
            mem[kid_ids] = beta
            korder = np.argsort(new_assign, kind="stable")
            kstarts = np.concatenate([[0], np.cumsum(kc)])[:-1]
            seg = points[rows[korder]]
            nonzero = kc > 0
            if nonzero.any():
                klo = np.minimum.reduceat(seg, kstarts[nonzero], axis=0)
                khi = np.maximum.reduceat(seg, kstarts[nonzero], axis=0)
                kid_nz = np.asarray(kid_ids)[nonzero]
                mbb_lo[kid_nz] = klo
                mbb_hi[kid_nz] = khi
            refine_map[si] = (tree, kid_ids)
            count[si] = 0
            mem[si] = 0
            active[si] = False

        def flush(si: int) -> None:
            full = int(count[si] - disk[si] * c_l) // c_l
            if full > 0:
                store.write_run(full)
                disk[si] += full
            mem[si] = 1
            active[si] = False

        def pick_victim() -> Optional[int]:
            # farthest active subspace (max-heap of the paper); splitting a
            # qualified subspace with >= C_B pages takes priority over
            # flushing it
            cand = [
                (qdist(i), i)
                for i in range(len(count))
                if active[i] and i not in refine_map
            ]
            if not cand:
                return None
            dist, i = max(cand)
            pages_i = -(-int(count[i]) // c_l)
            if dist == 0.0 and pages_i >= c_b:
                split_sub(i)
                return pick_victim()
            return i

        # the sampled pages are the subspaces' initial buffered contents
        ingest(idx[samp_use], samp_assign.astype(np.int32))

        # Step 2: distribute remaining pages with the heap flush policy
        rest = idx[np.concatenate([samp_extra, rest_local])] if (
            len(samp_extra) or len(rest_local)
        ) else np.zeros(0, dtype=np.int64)
        store.read_run(-(-len(rest) // c_l))
        for start in range(0, len(rest), c_l):
            rows = rest[start : start + c_l]
            uniq = ingest(rows, route(rows))
            # page-granular buffer bookkeeping, only where a page boundary
            # was actually crossed
            crossing = uniq[
                (count[uniq] - disk[uniq] * c_l) > mem[uniq] * c_l
            ]
            for g in crossing:
                g = int(g)
                if g in refine_map:  # split mid-page: rows already rerouted
                    continue
                pts = int(count[g])
                in_mem = pts - int(disk[g]) * c_l
                while in_mem > int(mem[g]) * c_l:
                    if active[g]:
                        if mem_used() >= M:
                            v = pick_victim()
                            if v is not None:
                                flush(v)
                                if v == g:
                                    break
                                continue
                        mem[g] += 1
                    else:
                        # inactive: single page, flushed whenever it fills
                        store.write_run(1)
                        disk[g] += 1
                        in_mem = pts - int(disk[g]) * c_l

        # Step 3: refine actives (their pages are in memory -> no reads).
        # One stable argsort of the arrival log yields every subspace's rows
        # in stream order.
        n_sub = len(count)
        all_a = np.concatenate(all_assign)
        all_r = np.concatenate(all_rows)
        gorder = np.argsort(all_a, kind="stable")
        sorted_rows = all_r[gorder]
        bounds = np.concatenate(
            [[0], np.cumsum(np.bincount(all_a, minlength=n_sub))]
        )
        nodes: list[Optional[Node]] = [None] * n_sub
        for i in range(n_sub):
            if i in refine_map:
                continue
            rows = sorted_rows[bounds[i] : bounds[i + 1]]
            if len(rows) == 0:
                continue
            if active[i]:
                entries = refine_subspace(points, rows, c_l, c_b, store)
                if len(entries) == 1:
                    nodes[i] = entries[0]
                else:
                    nodes[i] = Node(
                        mbb=mbb_of(points[rows]), page_id=-1, children=entries
                    )
            else:
                # flush trailing partial page; becomes an unrefined node
                rem = len(rows) - int(disk[i]) * c_l
                if rem > 0:
                    store.write_run(1)
                    disk[i] += 1
                nodes[i] = Node(
                    mbb=mbb_of(points[rows]),
                    page_id=-1,
                    raw_pages=int(disk[i]),
                    raw_points=rows,
                )

        # collapse nested splits bottom-up into entry lists + Step 4 merging
        def collect(si: int) -> Optional[Node]:
            if si not in refine_map:
                return nodes[si]
            tree, kids = refine_map[si]
            kid_nodes = [collect(k) for k in kids]
            cand = [kn if _mergeable(kn) else None for kn in kid_nodes]
            groups = merge_branches(tree, cand, c_b)
            _assign_pages(groups, store)
            real = [kn for kn in kid_nodes if kn is not None]
            for kn in real:
                if kn.page_id == -1:
                    page = store.alloc()
                    store.write(page)
                    kn.page_id = page
            if not real:
                return None
            if len(real) == 1:
                return real[0]
            page = store.alloc()
            store.write(page)
            return Node(
                mbb=np.stack(
                    [
                        np.min([k.mbb[0] for k in real], axis=0),
                        np.max([k.mbb[1] for k in real], axis=0),
                    ]
                ),
                page_id=page,
                children=real,
            )

        top_nodes: list[Optional[Node]] = [
            collect(s) for s in range(n_groups)
        ]
        cand = [tn if _mergeable(tn) else None for tn in top_nodes]
        groups = merge_branches(mst, cand, c_b)
        _assign_pages(groups, store)
        for tn in top_nodes:
            if tn is not None and tn.page_id == -1:
                page = store.alloc()
                store.write(page)
                tn.page_id = page
        return [tn for tn in top_nodes if tn is not None]


def _mergeable(n: Optional[Node]) -> bool:
    return n is not None and n.page_id == -1 and not n.is_leaf


def _assign_pages(groups, store) -> None:
    for group in groups:
        page = store.alloc()
        store.write(page)
        for nd in group:
            nd.page_id = page
