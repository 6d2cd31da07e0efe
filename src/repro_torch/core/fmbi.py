"""FMBI: Fast Multidimensional Bulkloaded Index (paper Section 3).

Five-step, scan-based bulk loading.  All sorting happens in main memory (the
defining property of the method); disk I/O is charged to a ``PageStore`` at
page granularity, faithfully following the paper's cost accounting:

  Step 1  read alpha*C_B random pages, build the Major SplitTree (MST)
  Step 2  single linear scan of the remaining pages, routing points through
          the MST into subspace buffers; buffer-overflow flushes render
          subspaces inactive
  Step 3  refine every *sparse* subspace (fits in the buffer) with the minor
          SplitTree recursion of Algorithm 1
  Step 4  conceptually merge underflowed branches (Algorithm 2) so that small
          entry lists share disk pages
  Step 5  recursively bulk load each *dense* subspace as a fresh dataset

Construction assembles a transient ``Node`` tree — every node carries the id
of the disk page its entry list (branch) or point payload (leaf) lives on —
which ``bulk_load`` flattens into the flat :class:`.nodetable.NodeTable`
the query layer traverses; page-read charging through the table is
bit-identical to walking the tree.

Scan engine
-----------
The hot paths run as true array-level scans, not interpreter loops:

  * Step 2 routes the whole stream once through the MST, derives per-page x
    per-subspace occupancy with a single ``bincount``, and *replays* the
    buffer's flush decisions from the prefix-sum occupancy arrays
    (:func:`_replay_step2`).  Only page-boundary crossings — O(total pages)
    events — are simulated; the per-point work is all vectorized.  The replay
    is decision-for-decision identical to the scalar ``SubspaceBuffers``
    simulation (kept below as the reference; ``bulk_load(step2="scalar")``
    runs it, and a regression test asserts identical ``IOStats`` and
    identical subspace assignments).
  * Each subspace's rows are gathered with one stable argsort of the routing
    assignment instead of per-page list appends.
  * :func:`refine_subspace` presorts the subspace once per dimension and
    partitions those orders in place, replacing the O(n log^2 n) re-sorting
    recursion with O(d n log n) boolean partitions.  Ties break by original
    stream order rather than by the re-sorted arrangement the naive
    recursion carried, so with duplicate coordinates a cut may land tied
    points on the other side; page counts, entry lists, and therefore the
    I/O accounting are unaffected (they depend only on page arithmetic).
    Leaf pages are allocated and written in run-granular batches
    (``PageStore.write_seq``) with ids identical to the per-page sequence.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np

from .. import tracing
from .nodetable import NodeTable, NodeView
from .pagestore import IOStats, PageStore, branch_capacity, leaf_capacity
from .splittree import (
    FlatSplitTree,
    build_group_median_tree,
    mbb_of,
)


# --------------------------------------------------------------------------
# Index node
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Node:
    mbb: np.ndarray                      # (2, d) [min; max]
    page_id: int                         # disk page holding this node's data
    children: Optional[list["Node"]] = None  # branch: child entries
    point_idx: Optional[np.ndarray] = None   # leaf: dataset row indices
    # AMBI: an unrefined node owns raw data pages not yet formed into a tree.
    raw_pages: int = 0                       # number of unrefined disk pages
    raw_points: Optional[np.ndarray] = None  # dataset row indices (unrefined)

    @property
    def is_leaf(self) -> bool:
        return self.point_idx is not None

    @property
    def is_unrefined(self) -> bool:
        return self.raw_points is not None

    def n_entries(self) -> int:
        if self.is_leaf:
            return len(self.point_idx)
        if self.is_unrefined:
            # an unrefined sparse subspace of P pages will always produce P
            # leaf entries when processed (paper Section 4.1)
            return self.raw_pages
        return len(self.children)

    def iter_leaves(self):
        stack = [self]
        while stack:
            n = stack.pop()
            if n.is_leaf:
                yield n
            elif n.children:
                stack.extend(n.children)


class Index:
    """A built index: a flat :class:`NodeTable` plus its substrate.

    The table is the query-time representation (see ``core/nodetable.py``);
    construction code passes the transient ``Node`` tree it assembled and
    the constructor flattens it.  ``root`` exposes a thin read-only
    ``NodeView`` for code that still walks the object shape (metrics,
    tests, examples).
    """

    def __init__(self, root, dim, leaf_cap, branch_cap, store, points):
        if isinstance(root, NodeTable):
            self.table = root
        else:
            self.table = NodeTable.from_tree(root, dim, n_points_hint=len(points))
        self.dim = dim
        self.leaf_cap = leaf_cap
        self.branch_cap = branch_cap
        self.store = store
        self.points = points  # the dataset (leaf perm ranges reference rows)

    @property
    def root(self) -> NodeView:
        return NodeView(self.table, 0)

    def count_nodes(self) -> tuple[int, int]:
        t = self.table
        leaves = int(((t.leaf_start >= 0) & ~t.unrefined).sum())
        branches = int((t.child_count > 0).sum())
        return leaves, branches

    def distinct_pages(self) -> int:
        """Physical index size in pages (merged nodes share pages)."""
        return len(np.unique(self.table.page_id))

    # -- snapshots ---------------------------------------------------------
    def save(self, path, *, include_points: bool = True) -> None:
        """Single-``.npz`` snapshot: table + substrate metadata (+ points)."""
        self.table.save(
            path,
            points=self.points if include_points else None,
            extra={
                "buffer_pages": self.store.buffer.capacity,
                "next_page_id": self.store.allocated_pages,
            },
        )

    @classmethod
    def load(cls, path, points: Optional[np.ndarray] = None) -> "Index":
        """Rebuild an :class:`Index` from a snapshot with a fresh (cold)
        ``PageStore`` of the original buffer capacity."""
        table, meta, pts = NodeTable.load(path)
        if points is not None:
            pts = points
        if pts is None:
            raise ValueError("snapshot has no points; pass them explicitly")
        store = PageStore(int(meta.get("buffer_pages", 64)))
        store.mark_allocated(
            int(meta.get("next_page_id", int(table.page_id.max()) + 1))
        )
        d = pts.shape[1]
        return cls(table, d, leaf_capacity(d), branch_capacity(d), store, pts)


# --------------------------------------------------------------------------
# Algorithm 1: minor-SplitTree refinement of a (sparse) subspace
# --------------------------------------------------------------------------
def refine_subspace(
    points: np.ndarray,
    idx: np.ndarray,
    leaf_cap: int,
    branch_cap: int,
    store: PageStore,
) -> list[Node]:
    """``generate_entries(P)`` of the paper: post-order recursion over the
    minor SplitTree, emitting FMBI leaf entries for single pages and wrapping
    entry lists that exceed C_B into branch entries.  All sorting is
    in-memory; the only I/O is writing finalized leaf/branch pages.

    The subspace is argsorted once per dimension up front; every recursive
    split partitions those orders membership-preservingly, so the per-node
    sorted views cost O(d * m) boolean compressions instead of a fresh
    O(m log m) sort.  Node MBBs and split spreads come straight from the
    sorted extremes, eliminating the per-node min/max reductions.  Subtrees
    that can never wrap (page count <= C_B) allocate and write their leaf
    pages as one run.

    Returns the subspace's root entry list (1..C_B nodes).
    """
    m = len(idx)
    if m == 0:
        return []
    pts = points[idx]
    d = pts.shape[1]
    cols = [np.ascontiguousarray(pts[:, j]) for j in range(d)]
    orders = [np.argsort(c, kind="stable") for c in cols]
    flag = np.zeros(m, dtype=bool)

    def spread_dim(orders_) -> int:
        # spread from the sorted extremes; ties resolve to the first max,
        # matching np.argmax over (max - min) in the naive recursion
        best, best_spread = 0, -np.inf
        for j in range(d):
            o = orders_[j]
            spread = cols[j][o[-1]] - cols[j][o[0]]
            if spread > best_spread:
                best, best_spread = j, spread
        return best

    def partition(orders_, dim: int, cut: int):
        o = orders_[dim]
        left_set = o[:cut]
        flag[left_set] = True
        left, right = [], []
        for j, oj in enumerate(orders_):
            if j == dim:
                left.append(left_set)
                right.append(o[cut:])
            else:
                mj = flag[oj]
                left.append(oj[mj])
                right.append(oj[~mj])
        flag[left_set] = False
        return left, right

    def make_leaf(orders_, page: int, last_dim: Optional[int]) -> Node:
        mbb = np.array(
            [
                [c[o[0]] for c, o in zip(cols, orders_)],
                [c[o[-1]] for c, o in zip(cols, orders_)],
            ]
        )
        local = orders_[last_dim] if last_dim is not None else None
        return Node(
            mbb=mbb,
            page_id=page,
            point_idx=idx[local] if local is not None else idx,
        )

    def leaf_run(orders_, n_pages: int, last_dim: Optional[int]) -> list[Node]:
        """A subtree of <= C_B pages can never wrap: it is exactly
        ``n_pages`` leaves, emitted in DFS order as one alloc/write run."""
        first = store.alloc(n_pages)
        store.write_seq(first, n_pages)
        out: list[Node] = []

        def lrec(orders__, n_pages_: int, last_dim_: Optional[int]) -> None:
            if n_pages_ <= 1:
                out.append(make_leaf(orders__, first + len(out), last_dim_))
                return
            dim = spread_dim(orders__)
            n_left = n_pages_ // 2
            cut = n_left * leaf_cap  # left half is ⌊P/2⌋ *full* pages
            left, right = partition(orders__, dim, cut)
            lrec(left, n_left, dim)
            lrec(right, n_pages_ - n_left, dim)

        lrec(orders_, n_pages, last_dim)
        return out

    def rec(orders_, n_pages: int, last_dim: Optional[int]) -> list[Node]:
        if n_pages <= branch_cap:
            return leaf_run(orders_, n_pages, last_dim)
        dim = spread_dim(orders_)
        n_left = n_pages // 2
        cut = n_left * leaf_cap
        left, right = partition(orders_, dim, cut)
        ne1 = rec(left, n_left, dim)
        ne2 = rec(right, n_pages - n_left, dim)
        if len(ne1) + len(ne2) <= branch_cap:
            return ne1 + ne2
        out = []
        for ne in (ne1, ne2):
            page = store.alloc()
            store.write(page)
            mbb = np.stack(
                [
                    np.min([e.mbb[0] for e in ne], axis=0),
                    np.max([e.mbb[1] for e in ne], axis=0),
                ]
            )
            out.append(Node(mbb=mbb, page_id=page, children=ne))
        return out

    total_pages = max(1, -(-m // leaf_cap))
    return rec(orders, total_pages, None)


# --------------------------------------------------------------------------
# Algorithm 2: merging of underflowed branches over the MST
# --------------------------------------------------------------------------
def merge_branches(
    tree: FlatSplitTree,
    subspace_nodes: list[Optional[Node]],
    branch_cap: int,
) -> list[list[Node]]:
    """Post-order MST traversal (Algorithm 2 of the paper).

    ``subspace_nodes[i]`` is the candidate node of MST leaf ``i`` — a branch
    whose entry-list page has *not yet been written* — or ``None`` for dense
    (unprocessed) subspaces, the paper's φ.  Nodes whose entry lists fit
    together within ``C_B`` are merged conceptually: their lists will share
    one disk page, while the FMBI root keeps one entry per subspace.

    Returns the final page groups; the caller allocates/writes one page per
    group and stamps ``page_id`` on every member.
    """
    groups: list[list[Node]] = []

    def emit(group: list[Node]) -> None:
        if group:
            groups.append(group)

    def mergeable(group: list[Node]) -> bool:
        return all(not n.is_leaf for n in group)

    def rec(child: int) -> Optional[list[Node]]:
        if child < 0:  # MST leaf -> subspace
            n = subspace_nodes[-child - 1]
            return None if n is None else [n]
        nl = rec(tree.left[child])
        nr = rec(tree.right[child])
        if nl is None:
            return nr
        if nr is None:
            return nl
        tl = sum(x.n_entries() for x in nl)
        tr = sum(x.n_entries() for x in nr)
        if tl + tr <= branch_cap and mergeable(nl) and mergeable(nr):
            return nl + nr  # merge: single shared page downstream
        # no merge possible: pass the smaller list upstream as the candidate
        if tl < tr:
            emit(nr)
            return nl
        emit(nl)
        return nr

    if tree.n_splits == 0:
        for n in subspace_nodes:
            if n is not None:
                emit([n])
        return groups
    last = rec(0)
    if last:
        emit(last)
    return groups


# --------------------------------------------------------------------------
# Step 2 buffer simulation (scalar reference)
# --------------------------------------------------------------------------
class SubspaceBuffers:
    """Models the Step-2 buffer at page granularity (scalar reference).

    Each subspace accumulates routed points.  Active subspaces keep all their
    pages in memory; on buffer exhaustion the allocating subspace flushes its
    full pages (-> inactive, paper Step 2).  A ``flush_victim`` hook lets
    AMBI substitute its distance max-heap victim selection.

    The production Step-2 path is :func:`_replay_step2`, which reproduces
    this state machine's decisions from vectorized prefix sums; this class is
    retained as the executable specification it is validated against.
    """

    def __init__(self, n_sub, leaf_cap, buffer_pages, store, init_pages):
        self.n = n_sub
        self.leaf_cap = leaf_cap
        self.M = buffer_pages
        self.store = store
        init = np.asarray(init_pages, dtype=np.int64)
        self.counts = init * leaf_cap            # points routed so far
        self.mem_pages = init.copy()             # buffer pages held
        self.disk_pages = np.zeros(n_sub, dtype=np.int64)
        self.active = np.ones(n_sub, dtype=bool)

    @property
    def mem_used(self) -> int:
        return int(self.mem_pages.sum())

    def pages_of(self, s: int) -> int:
        return int(-(-self.counts[s] // self.leaf_cap))

    def add_points(self, s: int, k: int, flush_victim=None) -> None:
        while k > 0:
            in_mem_pts = int(self.counts[s]) - int(self.disk_pages[s]) * self.leaf_cap
            room = int(self.mem_pages[s]) * self.leaf_cap - in_mem_pts
            if room > 0:
                take = min(k, room)
                self.counts[s] += take
                k -= take
                continue
            # need a fresh buffer page
            if self.mem_used >= self.M:
                victim = s if flush_victim is None else flush_victim(s)
                if victim is None:
                    # caller declined to flush (AMBI split path); spill over
                    self.mem_pages[s] += 1
                    self.counts[s] += min(k, self.leaf_cap)
                    k -= min(k, self.leaf_cap)
                    continue
                self.flush(int(victim))
                if victim != s:
                    continue
            self.mem_pages[s] += 1

    def flush(self, s: int) -> None:
        """Write subspace ``s``'s full in-memory pages to disk (Step 2)."""
        in_mem_pts = int(self.counts[s]) - int(self.disk_pages[s]) * self.leaf_cap
        full = in_mem_pts // self.leaf_cap
        if full > 0:
            self.store.write_run(full)
            self.disk_pages[s] += full
        self.mem_pages[s] = 1  # retain a single (partial) memory page
        self.active[s] = False

    def final_flush_partial(self, s: int) -> None:
        rem = int(self.counts[s]) - int(self.disk_pages[s]) * self.leaf_cap
        if rem > 0:
            self.store.write_run(1)
            self.disk_pages[s] += 1


# --------------------------------------------------------------------------
# Step 2: vectorized distribution
# --------------------------------------------------------------------------
def _group_slices(assign: np.ndarray, n_sub: int):
    """Stable group-by: ``order[bounds[s]:bounds[s+1]]`` are the positions
    with ``assign == s``, preserving stream order within each group."""
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=n_sub)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    return order, bounds


def _replay_step2(
    assign: np.ndarray,
    c_b: int,
    c_l: int,
    buffer_pages: int,
    alpha: int,
    store: PageStore,
):
    """Replay the Step-2 buffer decisions from prefix-occupancy arrays.

    ``assign`` is the MST subspace of every streamed point, in file order.
    One ``bincount`` produces the per-page x per-subspace occupancy; its
    per-subspace prefix sums tell exactly when each subspace's in-memory
    point count crosses a page boundary.  Only those crossings — O(pages)
    events, ordered by (page, subspace) like the scalar simulation — are
    replayed through the grow-or-flush state machine of
    :class:`SubspaceBuffers`; everything per-point stays in numpy.

    Returns (counts, disk_pages, active): the final buffer state.  Flush
    writes are charged to ``store`` with totals identical to the scalar run.
    """
    n_rest = len(assign)
    counts0 = alpha * c_l  # every subspace starts with its sampled pages
    if n_rest == 0:
        return (
            np.full(c_b, counts0, dtype=np.int64),
            np.zeros(c_b, dtype=np.int64),
            np.ones(c_b, dtype=bool),
        )
    n_chunks = -(-n_rest // c_l)
    chunk = np.arange(n_rest, dtype=np.int64) // c_l
    occ = np.bincount(
        chunk * c_b + assign.astype(np.int64), minlength=n_chunks * c_b
    )
    # cum[t, s]: points routed to s after page t has been distributed
    cum = occ.reshape(n_chunks, c_b).cumsum(axis=0) + counts0
    cum_t = np.ascontiguousarray(cum.T)  # (c_b, n_chunks) for searchsorted

    mem = np.full(c_b, alpha, dtype=np.int64)
    disk = np.zeros(c_b, dtype=np.int64)
    active = np.ones(c_b, dtype=bool)
    mem_used = int(alpha) * c_b
    writes = 0

    heap: list[tuple[int, int]] = []

    def push(s: int) -> None:
        cap = int(disk[s] + mem[s]) * c_l
        t = int(np.searchsorted(cum_t[s], cap, side="right"))
        if t < n_chunks:
            heapq.heappush(heap, (t, s))

    for s in range(c_b):
        push(s)
    while heap:
        t, s = heapq.heappop(heap)
        target = int(cum_t[s, t])
        while int(disk[s] + mem[s]) * c_l < target:
            if mem_used >= buffer_pages:
                # flush: the in-memory pages are all full; afterwards the
                # subspace keeps one (empty) page plus the fresh one
                writes += int(mem[s])
                disk[s] += mem[s]
                mem_used += 2 - int(mem[s])
                mem[s] = 2
                active[s] = False
            else:
                mem[s] += 1
                mem_used += 1
        push(s)
    store.write_run(writes)
    return cum[-1].astype(np.int64), disk, active


def _distribute_scalar(
    assign: np.ndarray,
    rest_idx: np.ndarray,
    samp_idx: np.ndarray,
    samp_assign: np.ndarray,
    c_b: int,
    c_l: int,
    buffer_pages: int,
    alpha: int,
    store: PageStore,
):
    """The seed's page-by-page Step-2 loop (reference implementation)."""
    bufs = SubspaceBuffers(c_b, c_l, buffer_pages, store, [alpha] * c_b)
    sub_points: list[list[np.ndarray]] = [[] for _ in range(c_b)]
    for s in range(c_b):
        sub_points[s].append(samp_idx[samp_assign == s])
    for start in range(0, len(rest_idx), c_l):
        sl = slice(start, start + c_l)
        a = assign[sl]
        ridx = rest_idx[sl]
        for s in np.unique(a):
            sel = ridx[a == s]
            sub_points[int(s)].append(sel)
            bufs.add_points(int(s), len(sel))
    sub_idx = [
        np.concatenate(sp) if sp else np.zeros(0, dtype=np.int64)
        for sp in sub_points
    ]
    return sub_idx, bufs.counts.copy(), bufs.disk_pages.copy(), bufs.active.copy()


def _distribute_vectorized(
    assign: np.ndarray,
    rest_idx: np.ndarray,
    samp_idx: np.ndarray,
    samp_assign: np.ndarray,
    c_b: int,
    c_l: int,
    buffer_pages: int,
    alpha: int,
    store: PageStore,
):
    """Array-level Step 2: one group-by for the rows, one replay for the
    buffer decisions.  Produces the same subspace row lists (same order) and
    the same I/O as :func:`_distribute_scalar`."""
    counts, disk, active = _replay_step2(
        assign, c_b, c_l, buffer_pages, alpha, store
    )
    samp_order, samp_bounds = _group_slices(samp_assign, c_b)
    rest_order, rest_bounds = _group_slices(assign, c_b)
    samp_sorted = samp_idx[samp_order]
    rest_sorted = rest_idx[rest_order]
    sub_idx = [
        np.concatenate(
            [
                samp_sorted[samp_bounds[s] : samp_bounds[s + 1]],
                rest_sorted[rest_bounds[s] : rest_bounds[s + 1]],
            ]
        )
        for s in range(c_b)
    ]
    return sub_idx, counts, disk, active


# --------------------------------------------------------------------------
# The bulk loader
# --------------------------------------------------------------------------
def bulk_load(
    points: np.ndarray,
    buffer_pages: int,
    store: Optional[PageStore] = None,
    rng: Optional[np.random.Generator] = None,
    *,
    charge_source_read: bool = True,
    step2: str = "vectorized",
) -> Index:
    """Bulk load FMBI over ``points`` with a ``buffer_pages`` buffer.

    ``step2`` selects the distribution engine: ``"vectorized"`` (default,
    prefix-sum replay) or ``"scalar"`` (the page-by-page reference loop);
    both produce identical indexes and identical ``IOStats``.  The result is
    a flat :class:`Index` (the construction tree is flattened into a
    :class:`NodeTable` and discarded).
    """
    rng = rng or np.random.default_rng(0)
    store = store or PageStore(buffer_pages)
    d = points.shape[1]
    with tracing.span("bulk_load"):
        root = _bulk_load_tree(
            points,
            buffer_pages,
            store,
            rng,
            charge_source_read=charge_source_read,
            step2=step2,
        )
        return Index(root, d, leaf_capacity(d), branch_capacity(d), store, points)


def _bulk_load_tree(
    points: np.ndarray,
    buffer_pages: int,
    store: PageStore,
    rng: np.random.Generator,
    *,
    charge_source_read: bool = True,
    step2: str = "vectorized",
    _depth: int = 0,
) -> Node:
    """The five-step construction; returns the transient ``Node`` root."""
    n, d = points.shape
    c_l = leaf_capacity(d)
    c_b = branch_capacity(d)
    p_total = -(-n // c_l)
    alpha = max(buffer_pages // c_b, 1)

    # ---- base case: the whole (sub)dataset fits in the buffer -----------
    if p_total <= min(buffer_pages, alpha * c_b) or n <= c_l:
        if charge_source_read:
            store.read_run(p_total)
        with tracing.span("bulk_load.refine"):
            entries = refine_subspace(points, np.arange(n), c_l, c_b, store)
        if len(entries) == 1:
            return entries[0]
        page = store.alloc()
        store.write(page)
        return Node(mbb=mbb_of(points), page_id=page, children=entries)

    # ---- Step 1: initial partitioning / Major SplitTree -----------------
    with tracing.span("bulk_load.route"):
        sample_pages = alpha * c_b
        page_of_point = np.arange(n) // c_l
        perm = rng.permutation(p_total)
        sampled = perm[:sample_pages]
        store.read_run(sample_pages)  # random page reads
        samp_mask = np.zeros(p_total, dtype=bool)
        samp_mask[sampled] = True
        samp_sel = samp_mask[page_of_point]
        samp_idx = np.flatnonzero(samp_sel)
        # a sampled trailing partial page can leave the sample short; top up
        # so that Step 1 operates on exactly alpha*C_B full pages
        need = sample_pages * c_l
        if len(samp_idx) < need:
            extra = np.flatnonzero(~samp_sel)[: need - len(samp_idx)]
            samp_sel[extra] = True
            samp_idx = np.flatnonzero(samp_sel)

        mst, _, samp_assign = build_group_median_tree(
            points[samp_idx], n_groups=c_b, group_pages=alpha, page_points=c_l
        )

        # ---- Step 2: distribute remaining pages -------------------------
        rest_idx = np.flatnonzero(~samp_sel)
        store.read_run(-(-len(rest_idx) // c_l))
        assign = (
            mst.route(points[rest_idx])
            if len(rest_idx)
            else np.zeros(0, dtype=np.int32)
        )
        distribute = (
            _distribute_scalar if step2 == "scalar" else _distribute_vectorized
        )
        sub_idx, counts, disk_pages, active = distribute(
            assign, rest_idx, samp_idx, samp_assign,
            c_b, c_l, buffer_pages, alpha, store,
        )

    # ---- Step 3: refine sparse subspaces (actives first: pages are free)
    pages_of = -(-counts // c_l)
    subspace_nodes: list[Optional[Node]] = [None] * c_b
    dense: list[int] = []
    with tracing.span("bulk_load.refine"):
        for s in np.argsort(~active, kind="stable"):
            s = int(s)
            if pages_of[s] > buffer_pages:
                dense.append(s)
                continue
            if len(sub_idx[s]) == 0:
                continue
            if not active[s]:
                store.read_run(int(disk_pages[s]))  # reload flushed pages
            entries = refine_subspace(points, sub_idx[s], c_l, c_b, store)
            node_mbb = (
                mbb_of(points[sub_idx[s]]) if len(sub_idx[s]) else np.zeros((2, d))
            )
            if len(entries) == 1:
                subspace_nodes[s] = entries[0]  # already has its own page
            else:
                # page deferred: assigned after Step 4 merging
                subspace_nodes[s] = Node(mbb=node_mbb, page_id=-1, children=entries)

    # ---- Step 4: conceptual merging, then write the root-entry pages ----
    merge_candidates: list[Optional[Node]] = [
        sn if (sn is not None and sn.page_id == -1) else None
        for sn in subspace_nodes
    ]
    groups = merge_branches(mst, merge_candidates, c_b)
    for group in groups:
        page = store.alloc()
        store.write(page)
        for node in group:
            node.page_id = page

    # ---- Step 5: dense subspaces -> recursive bulk load ------------------
    for s in dense:
        if counts[s] - disk_pages[s] * c_l > 0:  # trailing partial page
            store.write_run(1)
        sub_root = _bulk_load_tree(
            points[sub_idx[s]],
            buffer_pages,
            store,
            rng,
            charge_source_read=True,
            step2=step2,
            _depth=_depth + 1,
        )
        _rebase_leaves(sub_root, sub_idx[s])
        subspace_nodes[s] = sub_root

    root_page = store.alloc()
    store.write(root_page)
    return Node(
        mbb=mbb_of(points),
        page_id=root_page,
        children=[sn for sn in subspace_nodes if sn is not None],
    )


def _rebase_leaves(node: Node, base_idx: np.ndarray) -> None:
    stack = [node]
    while stack:
        n = stack.pop()
        if n.is_leaf:
            n.point_idx = base_idx[n.point_idx]
        elif n.is_unrefined:
            n.raw_points = base_idx[n.raw_points]
        elif n.children:
            stack.extend(n.children)
