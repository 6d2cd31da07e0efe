"""Flat index core: one array-backed node table for FMBI/AMBI.

The paper's indexes are defined by arrays-of-pages semantics — near-full,
zero-overlap nodes — yet the seed reproduction traversed a Python ``Node``
object graph one node at a time.  This module is the structure-of-arrays
representation every layer now shares (the move skd-tree and Flood make:
commit to an array encoding so traversal becomes vectorized arithmetic):

  * ``mbb_lo`` / ``mbb_hi``  (N, d)  node bounding boxes, split columns so
    whole-frontier intersection tests are two broadcast comparisons;
  * ``first_child`` / ``child_count``  CSR child ranges: the children of row
    ``i`` are rows ``first_child[i] : first_child[i] + child_count[i]``
    (rows are laid out level-by-level, so sibling blocks are contiguous and
    a frontier expands with one ragged-range gather);
  * ``page_id``  the disk page backing each node (merged Step-4 nodes share
    a page, exactly as in the object graph);
  * ``leaf_start`` / ``leaf_count``  point ranges into ``perm``, a
    leaf-contiguous permutation of dataset row ids (−1 start for branches);
  * ``unrefined`` / ``raw_pages``  AMBI's deferred nodes: an unrefined row
    owns raw disk pages and a ``perm`` range not yet formed into a subtree.

The table is the *query-time* representation.  Construction (FMBI Steps 1–5,
AMBI's adaptive build, the sort-based baselines) still assembles transient
``Node`` objects — that machinery is what charges paper-faithful I/O — and
flattens them here once; ``NodeView`` is the thin read-only object view kept
for tests, metrics, and examples that walk ``index.root``.

Because the table is plain arrays it is also the serialization and
accelerator boundary: ``save``/``load`` snapshot an index (optionally with
its points) into a single ``.npz`` (the same format the JAX package writes,
so either side loads the other's snapshots), ``merged`` combines
per-server tables into one global index for distributed snapshot shipping,
``to_grid_index`` re-lays the leaf level into the ``GridIndex`` grid so the
retrieval server can boot from a snapshot without rebuilding, and
``device_layout`` re-blocks the table into the fixed-shape arrays the
CUDA query engine (``core/queries_torch.py``) uploads.

This module is the PyTorch port's own copy of the JAX package's node
table.  It differs in two places: the bf16 compressed bounds come back as
``np.uint16`` bit patterns (no ``ml_dtypes``), and the ``JaxIndex`` bridge
is ``to_grid_index`` (host tensors of the port's ``GridIndex``).  The
post-boot mutators carry the writer-lock sanitizer hooks
(``analysis/runtime.py``) as the reference's do.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..analysis import runtime as _san
from .ioutil import atomic_output


# --------------------------------------------------------------------------
# bf16 compressed-MBB export (outward rounding; shared with queries_torch.py)
# --------------------------------------------------------------------------
def _bf16_outward(x: np.ndarray, up: bool) -> np.ndarray:
    """Round float32 values to bfloat16 toward +inf (``up``) or -inf.

    bfloat16 is float32 with the low 16 mantissa bits dropped, so rounding
    is pure bit arithmetic: truncation moves every value toward zero; when
    that is the wrong direction for the requested rounding, step one bf16
    ulp outward by incrementing the truncated magnitude (saturating into
    +/-inf is fine — an infinite bound is still conservative).

    Returns the bf16 bit patterns as ``np.uint16`` (the top 16 bits of the
    rounded float32 word); ``torch.from_numpy(u16).view(torch.bfloat16)``
    reinterprets them without a copy."""
    f = np.ascontiguousarray(np.asarray(x, dtype=np.float32))
    u = f.view(np.uint32)
    frac = u & np.uint32(0xFFFF)
    trunc = u & ~np.uint32(0xFFFF)
    neg = (u >> 31) != 0
    step = (frac != 0) & (neg != up)
    out = np.where(step, trunc + (np.uint32(1) << 16), trunc)
    return (out >> 16).astype(np.uint16)


def compress_boxes_bf16(
    lo: np.ndarray, hi: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Outward-rounded bfloat16 copies of f32 box columns (``np.uint16``
    bit patterns, see :func:`_bf16_outward`).

    ``lo`` rounds toward -inf and ``hi`` toward +inf, so every compressed
    box *contains* its f32 box: any query intersecting the f32 box also
    intersects the compressed one (no false negatives, ever), and the
    squared mindist to the compressed box never exceeds the f32 mindist
    (a superset-safe lower bound for k-NN pruning).  The device engine
    re-checks borderline boxes against the exact f32 columns, so results
    stay id-identical — compression only adds candidates, never drops one.
    """
    return _bf16_outward(lo, up=False), _bf16_outward(hi, up=True)


# --------------------------------------------------------------------------
# ragged-range helper (shared with queries.py)
# --------------------------------------------------------------------------
def ragged_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate ``[starts[i], starts[i]+counts[i])`` into one index array
    without a Python loop (the standard repeat/cumsum trick)."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    offs = np.cumsum(counts) - counts
    return np.repeat(np.asarray(starts, dtype=np.int64) - offs, counts) + np.arange(
        total, dtype=np.int64
    )


class NodeTable:
    """Structure-of-arrays index representation (see module docstring).

    Rows are appended through an amortized-doubling growth policy so AMBI
    refinement — which grafts freshly built subtrees under unrefined rows —
    costs O(rows added), not O(table) per refinement.  Public accessors
    return views trimmed to the live row/perm counts.
    """

    __slots__ = (
        "dim",
        "_n",
        "_np",
        "_mbb_lo",
        "_mbb_hi",
        "_page_id",
        "_first_child",
        "_child_count",
        "_leaf_start",
        "_leaf_count",
        "_raw_pages",
        "_unrefined",
        "_perm",
        "_dfs",
        "node_reallocs",
        "perm_reallocs",
        "node_rows_copied",
        "perm_elems_copied",
        "_san_lock",  # REPRO_SANITIZE: writer lock this table is bound to
    )

    def __init__(self, dim: int, node_capacity: int = 8, perm_capacity: int = 8):
        self.dim = int(dim)
        self._n = 0
        self._np = 0
        self._san_lock = None
        # Reallocation accounting: how many times the backing arrays were
        # reallocated and how many live elements those reallocations copied.
        # Under amortized doubling total copies stay O(final size); a
        # regression here means some path reintroduced O(n^2) append cost.
        self.node_reallocs = 0
        self.perm_reallocs = 0
        self.node_rows_copied = 0
        self.perm_elems_copied = 0
        self._mbb_lo = np.zeros((node_capacity, dim))
        self._mbb_hi = np.zeros((node_capacity, dim))
        self._page_id = np.zeros(node_capacity, dtype=np.int64)
        self._first_child = np.zeros(node_capacity, dtype=np.int64)
        self._child_count = np.zeros(node_capacity, dtype=np.int64)
        self._leaf_start = np.full(node_capacity, -1, dtype=np.int64)
        self._leaf_count = np.zeros(node_capacity, dtype=np.int64)
        self._raw_pages = np.zeros(node_capacity, dtype=np.int64)
        self._unrefined = np.zeros(node_capacity, dtype=bool)
        self._perm = np.zeros(perm_capacity, dtype=np.int64)
        self._dfs: Optional[np.ndarray] = None

    # -- trimmed views -----------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return self._n

    @property
    def n_perm(self) -> int:
        return self._np

    @property
    def mbb_lo(self) -> np.ndarray:
        return self._mbb_lo[: self._n]

    @property
    def mbb_hi(self) -> np.ndarray:
        return self._mbb_hi[: self._n]

    @property
    def page_id(self) -> np.ndarray:
        return self._page_id[: self._n]

    @property
    def first_child(self) -> np.ndarray:
        return self._first_child[: self._n]

    @property
    def child_count(self) -> np.ndarray:
        return self._child_count[: self._n]

    @property
    def leaf_start(self) -> np.ndarray:
        return self._leaf_start[: self._n]

    @property
    def leaf_count(self) -> np.ndarray:
        return self._leaf_count[: self._n]

    @property
    def raw_pages(self) -> np.ndarray:
        return self._raw_pages[: self._n]

    @property
    def unrefined(self) -> np.ndarray:
        return self._unrefined[: self._n]

    @property
    def perm(self) -> np.ndarray:
        return self._perm[: self._np]

    # -- row classification ------------------------------------------------
    def is_leaf_row(self, rows) -> np.ndarray:
        return (self.leaf_start[rows] >= 0) & ~self.unrefined[rows]

    def leaf_rows(self) -> np.ndarray:
        return np.flatnonzero((self.leaf_start >= 0) & ~self.unrefined)

    def point_rows(self, row: int) -> np.ndarray:
        """Dataset row ids of a leaf/unrefined row (view into ``perm``)."""
        s = int(self._leaf_start[row])
        if s < 0:
            return np.zeros(0, dtype=np.int64)
        return self._perm[s : s + int(self._leaf_count[row])]

    def children_of(self, row: int) -> range:
        f = int(self._first_child[row])
        return range(f, f + int(self._child_count[row]))

    # -- growth ------------------------------------------------------------
    def _grow_nodes(self, k: int) -> int:
        """Reserve ``k`` rows; returns the first new row id."""
        need = self._n + k
        cap = len(self._page_id)
        if need > cap:
            # Always at least double: growing to the exact ``need`` would
            # make a run of large-then-small appends reallocate (and copy
            # the whole table) on every small append — the O(n^2) pattern
            # sustained ingest streams hit.  Doubling keeps total copy work
            # O(final size) regardless of append sizing.
            new = max(need, 2 * cap)
            self.node_reallocs += 1
            self.node_rows_copied += self._n
            grow2 = lambda a: np.concatenate(
                [a, np.zeros((new - cap, self.dim), a.dtype)]
            )
            grow1 = lambda a, fill=0: np.concatenate(
                [a, np.full(new - cap, fill, a.dtype)]
            )
            self._mbb_lo = grow2(self._mbb_lo)
            self._mbb_hi = grow2(self._mbb_hi)
            self._page_id = grow1(self._page_id)
            self._first_child = grow1(self._first_child)
            self._child_count = grow1(self._child_count)
            self._leaf_start = grow1(self._leaf_start, -1)
            self._leaf_count = grow1(self._leaf_count)
            self._raw_pages = grow1(self._raw_pages)
            self._unrefined = grow1(self._unrefined)
        first = self._n
        self._n = need
        return first

    def _append_perm(self, rows: np.ndarray) -> int:
        """Append dataset row ids to ``perm``; returns their start offset."""
        k = len(rows)
        need = self._np + k
        cap = len(self._perm)
        if need > cap:
            new = max(need, 2 * cap)
            self.perm_reallocs += 1
            self.perm_elems_copied += self._np
            self._perm = np.concatenate(
                [self._perm, np.zeros(new - cap, np.int64)]
            )
        start = self._np
        self._perm[start:need] = rows
        self._np = need
        return start

    # -- construction from a Node tree ------------------------------------
    def _set_row(self, row: int, node) -> None:
        """Write one construction ``Node``'s scalar fields into ``row``
        (children, if any, are linked by the caller)."""
        self._mbb_lo[row] = node.mbb[0]
        self._mbb_hi[row] = node.mbb[1]
        self._page_id[row] = node.page_id
        self._first_child[row] = 0
        self._child_count[row] = 0
        self._raw_pages[row] = 0
        self._unrefined[row] = False
        if node.point_idx is not None:  # leaf
            self._leaf_start[row] = self._append_perm(
                np.asarray(node.point_idx, dtype=np.int64)
            )
            self._leaf_count[row] = len(node.point_idx)
        elif node.raw_points is not None:  # AMBI unrefined
            self._leaf_start[row] = self._append_perm(
                np.asarray(node.raw_points, dtype=np.int64)
            )
            self._leaf_count[row] = len(node.raw_points)
            self._raw_pages[row] = node.raw_pages
            self._unrefined[row] = True
        else:
            self._leaf_start[row] = -1
            self._leaf_count[row] = 0

    def _append_level_order(self, queue: list, rows: list[int]) -> None:
        """Flatten ``queue[i]``'s subtrees below already-written ``rows[i]``,
        level by level, so every sibling block is contiguous."""
        head = 0
        while head < len(queue):
            node, row = queue[head], rows[head]
            head += 1
            kids = node.children
            if not kids:
                continue
            first = self._grow_nodes(len(kids))
            self._first_child[row] = first
            self._child_count[row] = len(kids)
            for j, kid in enumerate(kids):
                self._set_row(first + j, kid)
                queue.append(kid)
                rows.append(first + j)
        self._dfs = None

    @classmethod
    def from_tree(cls, root, dim: int, n_points_hint: int = 0) -> "NodeTable":
        """Flatten a construction ``Node`` tree (level order, root = row 0)."""
        t = cls(dim, node_capacity=16, perm_capacity=max(n_points_hint, 16))
        t._grow_nodes(1)
        t._set_row(0, root)
        t._append_level_order([root], [0])
        return t

    @classmethod
    def single_unrefined(
        cls, mbb: np.ndarray, page_id: int, raw_pages: int, rows: np.ndarray
    ) -> "NodeTable":
        """AMBI's starting state: the whole dataset as one unrefined root."""
        t = cls(mbb.shape[1], node_capacity=16, perm_capacity=max(len(rows), 16))
        t._grow_nodes(1)
        t._mbb_lo[0] = mbb[0]
        t._mbb_hi[0] = mbb[1]
        t._page_id[0] = page_id
        t._leaf_start[0] = t._append_perm(np.asarray(rows, dtype=np.int64))
        t._leaf_count[0] = len(rows)
        t._raw_pages[0] = raw_pages
        t._unrefined[0] = True
        return t

    # -- AMBI refinement: graft a freshly built subtree ---------------------
    def graft(self, row: int, entries: list) -> None:
        """Replace unrefined ``row`` by the subtree ``entries`` (a root entry
        list from ``refine_subspace`` / the adaptive build).

        Mirrors the object-graph ``_become`` semantics: a single entry is
        adopted in place (the row takes its MBB, page and payload), multiple
        entries turn the row into a branch whose MBB tightens to their union.
        New rows and perm segments are *appended* (amortized growth); the
        row's previous raw-point segment simply goes dead.
        """
        _san.check_write(self, "graft")
        row = int(row)
        if len(entries) == 1:
            e = entries[0]
            self._set_row(row, e)
            if e.children:
                self._append_level_order([e], [row])
            return
        lo = np.min([e.mbb[0] for e in entries], axis=0)
        hi = np.max([e.mbb[1] for e in entries], axis=0)
        self._mbb_lo[row] = lo
        self._mbb_hi[row] = hi
        self._leaf_start[row] = -1
        self._leaf_count[row] = 0
        self._raw_pages[row] = 0
        self._unrefined[row] = False
        first = self._grow_nodes(len(entries))
        self._first_child[row] = first
        self._child_count[row] = len(entries)
        queue, rows = [], []
        for j, e in enumerate(entries):
            self._set_row(first + j, e)
            queue.append(e)
            rows.append(first + j)
        self._append_level_order(queue, rows)

    # -- streaming-mirror surgery -------------------------------------------
    # The streaming device mirror (core/streaming.py) is one append-only
    # table whose synthetic root spans the live LSM tiers.  These helpers
    # are its whole mutation surface: append a tier subtree, re-point the
    # root's CSR child block at the live tier roots (as freshly appended
    # row copies, keeping the block contiguous), and neutralize retired
    # rows.  Rows are never removed — ``DeviceTable.apply_delta`` requires
    # previously exported leaf rows to persist — so retirement inverts the
    # MBB and zeroes the fill count instead: traversal never reaches a
    # detached row, and the recomputed device metadata makes its leaf block
    # unmatchable (inverted box) and empty (count 0) for the global
    # leaf-table pruning paths.
    def append_subtree(self, src: "NodeTable") -> int:
        """Append every row of ``src`` (root first); returns the base row.

        ``src.perm`` is appended wholesale, so its ids must already be in
        this table's id namespace (streaming tiers index the global point
        buffer directly).  Page ids are taken verbatim — the tiers share
        one ``PageStore`` namespace with the mirror.
        """
        _san.check_write(self, "append_subtree")
        k = src.n_nodes
        base = self._grow_nodes(k)
        pbase = self._np
        self._append_perm(src.perm)
        sl = slice(base, base + k)
        self._mbb_lo[sl] = src.mbb_lo
        self._mbb_hi[sl] = src.mbb_hi
        self._page_id[sl] = src.page_id
        self._child_count[sl] = src.child_count
        self._leaf_count[sl] = src.leaf_count
        self._raw_pages[sl] = src.raw_pages
        self._unrefined[sl] = src.unrefined
        self._first_child[sl] = np.where(
            src.child_count > 0, src.first_child + base, 0
        )
        self._leaf_start[sl] = np.where(
            src.leaf_start >= 0, src.leaf_start + pbase, -1
        )
        self._dfs = None
        return base

    def append_row_copies(self, rows) -> int:
        """Append verbatim copies of ``rows`` (pointers preserved, so a copy
        of a branch adopts the original's children); returns the base row."""
        _san.check_write(self, "append_row_copies")
        rows = np.asarray(rows, dtype=np.int64)
        base = self._grow_nodes(len(rows))
        sl = slice(base, base + len(rows))
        self._mbb_lo[sl] = self._mbb_lo[rows]
        self._mbb_hi[sl] = self._mbb_hi[rows]
        self._page_id[sl] = self._page_id[rows]
        self._first_child[sl] = self._first_child[rows]
        self._child_count[sl] = self._child_count[rows]
        self._leaf_start[sl] = self._leaf_start[rows]
        self._leaf_count[sl] = self._leaf_count[rows]
        self._raw_pages[sl] = self._raw_pages[rows]
        self._unrefined[sl] = self._unrefined[rows]
        self._dfs = None
        return base

    def set_root_children(self, first: int, count: int) -> None:
        """Re-point row 0's CSR child block and tighten its MBB."""
        _san.check_write(self, "set_root_children")
        self._first_child[0] = first
        self._child_count[0] = count
        self._mbb_lo[0] = self._mbb_lo[first : first + count].min(axis=0)
        self._mbb_hi[0] = self._mbb_hi[first : first + count].max(axis=0)
        self._leaf_start[0] = -1
        self._leaf_count[0] = 0
        self._dfs = None

    def append_branch(self, first: int, count: int, page_id: int) -> int:
        """Append a branch row adopting the existing contiguous row block
        ``[first, first + count)`` as its children; returns the new row."""
        _san.check_write(self, "append_branch")
        r = self._grow_nodes(1)
        self._mbb_lo[r] = self._mbb_lo[first : first + count].min(axis=0)
        self._mbb_hi[r] = self._mbb_hi[first : first + count].max(axis=0)
        self._page_id[r] = page_id
        self._first_child[r] = first
        self._child_count[r] = count
        self._leaf_start[r] = -1
        self._leaf_count[r] = 0
        self._raw_pages[r] = 0
        self._unrefined[r] = False
        self._dfs = None
        return r

    def neutralize_rows(self, rows) -> None:
        """Mark detached rows dead for every engine: inverted MBB (matches
        no window, +inf k-NN mindist) and zero fill count."""
        _san.check_write(self, "neutralize_rows")
        rows = np.asarray(rows, dtype=np.int64)
        # 1e17: beyond any data yet small enough that f32 mindist math on
        # the inverted box (sums and squares of ~2e17) stays finite
        big = 1e17
        self._mbb_lo[rows] = big
        self._mbb_hi[rows] = -big
        self._leaf_count[rows] = 0
        self._dfs = None

    # -- vacuum --------------------------------------------------------------
    def compact(self) -> np.ndarray:
        """Vacuum the dead ``perm`` segments (and any unreachable rows)
        that grafting accumulates.

        Grafting never rewrites in place: refining an unrefined row appends
        a fresh perm segment for every new leaf and the row's old raw
        segment simply goes dead, so a long refinement workload leaves
        ``n_perm`` far above the live point count (and the next snapshot or
        device export correspondingly padded).  ``compact`` rebuilds the
        table in BFS level order — rows renumber, sibling blocks stay
        contiguous, children keep higher ids than their parent — and
        rewrites ``perm`` to exactly the live segments in that row order,
        so afterwards ``n_perm`` equals the live point count.  Page ids,
        tree shape, and therefore traversal I/O are unchanged.

        Returns the old-row -> new-row map (``-1`` for dropped rows) so
        host-side scaffolding (device-table slot maps, shard root lists)
        can be rebased instead of rebuilt.
        """
        _san.check_write(self, "compact")
        blocks = []
        cur = np.zeros(1, dtype=np.int64)
        while cur.size:
            blocks.append(cur)
            cur = ragged_ranges(self.first_child[cur], self.child_count[cur])
        order = np.concatenate(blocks)
        n_new = len(order)
        remap = np.full(self._n, -1, dtype=np.int64)
        remap[order] = np.arange(n_new)
        mbb_lo = self.mbb_lo[order].copy()
        mbb_hi = self.mbb_hi[order].copy()
        page_id = self.page_id[order].copy()
        child_count = self.child_count[order].copy()
        first_child = np.where(
            child_count > 0, remap[self.first_child[order]], 0
        )
        leaf_count = self.leaf_count[order].copy()
        raw_pages = self.raw_pages[order].copy()
        unrefined = self.unrefined[order].copy()
        payload = self.leaf_start[order] >= 0
        starts = self.leaf_start[order]
        sel = ragged_ranges(starts[payload], leaf_count[payload])
        perm = self.perm[sel].copy()
        leaf_start = np.full(n_new, -1, dtype=np.int64)
        leaf_start[payload] = (
            np.cumsum(leaf_count[payload]) - leaf_count[payload]
        )
        self._n = n_new
        self._np = len(perm)
        # Rebuild with capacity headroom: exact-fit arrays would force the
        # very next graft — however small — to copy the whole table again,
        # so a compact-then-trickle-grafts serving loop goes quadratic.
        cap = n_new + n_new // 8 + 16
        pcap = len(perm) + len(perm) // 8 + 16
        self._mbb_lo = self._pad_cap(mbb_lo, cap)
        self._mbb_hi = self._pad_cap(mbb_hi, cap)
        self._page_id = self._pad_cap(page_id, cap)
        self._first_child = self._pad_cap(first_child, cap)
        self._child_count = self._pad_cap(child_count, cap)
        self._leaf_start = self._pad_cap(leaf_start, cap, -1)
        self._leaf_count = self._pad_cap(leaf_count, cap)
        self._raw_pages = self._pad_cap(raw_pages, cap)
        self._unrefined = self._pad_cap(unrefined, cap)
        self._perm = self._pad_cap(perm, pcap)
        self._dfs = None
        return remap

    @staticmethod
    def _pad_cap(a: np.ndarray, cap: int, fill=0) -> np.ndarray:
        """Copy ``a`` into a ``cap``-capacity array (headroom for appends)."""
        shape = (cap, a.shape[1]) if a.ndim == 2 else cap
        out = np.full(shape, fill, a.dtype)
        out[: len(a)] = a
        return out

    # -- traversal orders ---------------------------------------------------
    def parent_rows(self) -> np.ndarray:
        """Parent row of every row (−1 for the root); one ragged gather."""
        par = np.full(self._n, -1, dtype=np.int64)
        branches = np.flatnonzero(self.child_count > 0)
        if len(branches):
            kids = ragged_ranges(
                self.first_child[branches], self.child_count[branches]
            )
            par[kids] = np.repeat(branches, self.child_count[branches])
        return par

    def dfs_order(self) -> np.ndarray:
        """Rows in the depth-first pop order of the object-graph traversal
        (children expanded onto a stack, so visited in reverse); cached until
        the next graft.  This is the order the query layer replays page reads
        in, which pins IOStats to the object-graph engine bit for bit."""
        if self._dfs is None:
            fc, cc = self._first_child, self._child_count
            order = np.empty(self._n, dtype=np.int64)
            stack = [0]
            i = 0
            while stack:
                r = stack.pop()
                order[i] = r
                i += 1
                k = int(cc[r])
                if k:
                    stack.extend(range(int(fc[r]), int(fc[r]) + k))
            self._dfs = order[:i]
        return self._dfs

    def subtree_points(self) -> np.ndarray:
        """Points under each row (leaves count their range, unrefined rows
        their raw range), accumulated bottom-up over the BFS levels reached
        from the root.  Level-wise accumulation (rather than a reverse row
        sweep) keeps this correct for append-only tables — the streaming
        mirror's root child block is appended *after* the subtrees it
        points at, so children may live at lower row ids than their parent.
        Unreachable (detached) rows keep their own leaf count."""
        sizes = np.where(self.leaf_start >= 0, self.leaf_count, 0).astype(np.int64)
        blocks = []
        cur = np.zeros(min(1, self._n), dtype=np.int64)
        while cur.size:
            blocks.append(cur)
            cur = ragged_ranges(self.first_child[cur], self.child_count[cur])
        for blk in reversed(blocks):
            cc = self.child_count[blk]
            parents = blk[cc > 0]
            if len(parents) == 0:
                continue
            kids = ragged_ranges(self.first_child[parents], cc[cc > 0])
            np.add.at(sizes, np.repeat(parents, cc[cc > 0]), sizes[kids])
        return sizes

    # -- serialization ------------------------------------------------------
    def save(
        self,
        path,
        points: Optional[np.ndarray] = None,
        extra: Optional[dict] = None,
    ) -> None:
        """Snapshot the table (and optionally the dataset) into one ``.npz``."""
        payload = {
            "mbb_lo": self.mbb_lo,
            "mbb_hi": self.mbb_hi,
            "page_id": self.page_id,
            "first_child": self.first_child,
            "child_count": self.child_count,
            "leaf_start": self.leaf_start,
            "leaf_count": self.leaf_count,
            "raw_pages": self.raw_pages,
            "unrefined": self.unrefined,
            "perm": self.perm,
            "dim": np.int64(self.dim),
        }
        if points is not None:
            payload["points"] = points
        for k, v in (extra or {}).items():
            payload[f"meta_{k}"] = np.asarray(v)
        # Crash-safe write: a kill mid-save must never leave a torn .npz at
        # ``path`` — the snapshot is often the only durable copy.  The
        # shared tmp+fsync+replace helper writes into the destination
        # directory and atomically swaps (np.savez appends ".npz" to bare
        # string paths, so hand it the open handle).
        path = os.fspath(path)
        if not path.endswith(".npz"):
            path = path + ".npz"
        with atomic_output(path) as f:
            np.savez(f, **payload)

    def equals(self, other: "NodeTable") -> bool:
        """Bit-identical structural equality (the crash-recovery invariant:
        snapshot + journal replay must land exactly here)."""
        if self.dim != other.dim or self._n != other._n or self._np != other._np:
            return False
        return all(
            np.array_equal(getattr(self, name), getattr(other, name))
            for name in (
                "mbb_lo", "mbb_hi", "page_id", "first_child", "child_count",
                "leaf_start", "leaf_count", "raw_pages", "unrefined", "perm",
            )
        )

    COLUMNS = (
        "mbb_lo", "mbb_hi", "page_id", "first_child", "child_count",
        "leaf_start", "leaf_count", "raw_pages", "unrefined", "perm",
    )

    @classmethod
    def from_columns(cls, dim: int, cols) -> "NodeTable":
        """A table holding copies of the SoA columns in ``cols`` (a mapping
        of the names in :attr:`COLUMNS` to arrays), with capacity headroom:
        a table that immediately starts grafting must not pay a full-table
        copy on the first append."""
        n = len(cols["page_id"])
        np_ = len(cols["perm"])
        t = cls(dim, node_capacity=n + n // 8 + 16,
                perm_capacity=np_ + np_ // 8 + 16)
        t._n = n
        t._np = np_
        t._mbb_lo[:n] = cols["mbb_lo"]
        t._mbb_hi[:n] = cols["mbb_hi"]
        t._page_id[:n] = cols["page_id"]
        t._first_child[:n] = cols["first_child"]
        t._child_count[:n] = cols["child_count"]
        t._leaf_start[:n] = cols["leaf_start"]
        t._leaf_count[:n] = cols["leaf_count"]
        t._raw_pages[:n] = cols["raw_pages"]
        t._unrefined[:n] = cols["unrefined"]
        t._perm[:np_] = cols["perm"]
        return t

    @classmethod
    def load(cls, path) -> tuple["NodeTable", dict, Optional[np.ndarray]]:
        """Load a snapshot (this package's or the JAX package's ``save``);
        returns (table, meta, points-or-None)."""
        with np.load(path) as z:
            t = cls.from_columns(int(z["dim"]), z)
            meta = {
                k[len("meta_") :]: z[k][()] for k in z.files if k.startswith("meta_")
            }
            points = z["points"] if "points" in z.files else None
        return t, meta, points

    # -- distributed merge ---------------------------------------------------
    @classmethod
    def merged(
        cls,
        tables: list["NodeTable"],
        perm_maps: list[np.ndarray],
        page_offsets: list[int],
        root_page: int,
    ) -> "NodeTable":
        """Merge per-server tables into one global table.

        A synthetic root (row 0) takes the server roots as children; server
        ``s``'s local dataset rows are mapped to global ids through
        ``perm_maps[s]`` and its page ids shifted by ``page_offsets[s]`` so
        the merged snapshot has one flat page namespace.  Server-root rows
        are relocated to rows ``1..m`` (keeping the root's CSR child block
        contiguous); every other row shifts by a per-server base offset.
        """
        if not (len(tables) == len(perm_maps) == len(page_offsets)):
            raise ValueError(
                f"merge inputs misaligned: {len(tables)} tables, "
                f"{len(perm_maps)} perm maps, {len(page_offsets)} page offsets"
            )
        live = [t for t in tables if t.n_nodes > 0]
        live_maps = [m for t, m in zip(tables, perm_maps) if t.n_nodes > 0]
        live_offs = [o for t, o in zip(tables, page_offsets) if t.n_nodes > 0]
        m = len(live)
        if m == 0:
            raise ValueError("nothing to merge")
        dim = live[0].dim
        total_nodes = 1 + sum(t.n_nodes for t in live)
        total_perm = sum(t.n_perm for t in live)
        out = cls(dim, node_capacity=total_nodes + total_nodes // 8 + 16,
                  perm_capacity=total_perm + total_perm // 8 + 16)
        out._grow_nodes(total_nodes)
        # row mapping: server root -> 1 + s; row r > 0 -> base_s + r - 1
        bases = []
        base = 1 + m
        for t in live:
            bases.append(base)
            base += t.n_nodes - 1
        perm_off = 0
        for s, t in enumerate(live):
            n = t.n_nodes
            root_dst = slice(1 + s, 2 + s)
            rest_dst = slice(bases[s], bases[s] + n - 1)
            for dst, src in ((root_dst, slice(0, 1)), (rest_dst, slice(1, n))):
                out._mbb_lo[dst] = t.mbb_lo[src]
                out._mbb_hi[dst] = t.mbb_hi[src]
                out._page_id[dst] = t.page_id[src] + live_offs[s]
                out._child_count[dst] = t.child_count[src]
                out._leaf_count[dst] = t.leaf_count[src]
                out._raw_pages[dst] = t.raw_pages[src]
                out._unrefined[dst] = t.unrefined[src]
                # child pointers: children are never the server root (row 0)
                out._first_child[dst] = np.where(
                    t.child_count[src] > 0, t.first_child[src] + bases[s] - 1, 0
                )
                out._leaf_start[dst] = np.where(
                    t.leaf_start[src] >= 0, t.leaf_start[src] + perm_off, -1
                )
            out._perm[perm_off : perm_off + t.n_perm] = live_maps[s][t.perm]
            perm_off += t.n_perm
        out._np = perm_off
        out._mbb_lo[0] = out._mbb_lo[1 : 1 + m].min(axis=0)
        out._mbb_hi[0] = out._mbb_hi[1 : 1 + m].max(axis=0)
        out._page_id[0] = root_page
        out._first_child[0] = 1
        out._child_count[0] = m
        out._leaf_start[0] = -1
        return out

    # -- sharding ------------------------------------------------------------
    def subtable(self, roots, sizes: Optional[np.ndarray] = None) -> "NodeTable":
        """Extract the subtrees rooted at ``roots`` into a standalone table.

        A single root is adopted in place; multiple roots hang under a
        synthetic root whose MBB tightens to their union (the same shape
        :meth:`merged` produces).  ``perm`` values are copied verbatim, so
        the sub-table keeps addressing the *parent's* dataset rows — the
        property the sharded query engine relies on: every shard answers
        with global ids and results merge by concatenation.  ``sizes`` is
        an optional precomputed :meth:`subtree_points` array (callers that
        extract several sub-tables pass it once instead of re-sweeping).
        """
        from .fmbi import Node  # function-local: fmbi imports this module

        roots = [int(r) for r in roots]
        if not roots:
            raise ValueError("subtable needs at least one root row")
        if len(roots) == 1:
            src = NodeView(self, roots[0])
        else:
            src = Node(
                mbb=np.stack(
                    [
                        self.mbb_lo[roots].min(axis=0),
                        self.mbb_hi[roots].max(axis=0),
                    ]
                ),
                page_id=int(self._page_id[0]),
                children=[NodeView(self, r) for r in roots],
            )
        if sizes is None:
            sizes = self.subtree_points()
        hint = int(sizes[roots].sum())
        return NodeTable.from_tree(src, self.dim, n_points_hint=hint)

    def shard_plan(
        self, m: int, sizes: Optional[np.ndarray] = None
    ) -> list[list[int]]:
        """The root-row lists :meth:`shard` extracts its sub-tables from
        (exposed so callers that later need to *re-extract* a shard — the
        adaptive refresh path — can record which subspaces each shard
        owns).  Row lists are sorted; empty bins are dropped.  ``sizes``
        is an optional precomputed :meth:`subtree_points` array.
        """
        if m < 1:
            raise ValueError(f"shard count must be >= 1, got {m}")
        if m == 1 or self._child_count[0] == 0:
            return [[0]]
        if sizes is None:
            sizes = self.subtree_points()
        frontier = list(self.children_of(0))
        while len(frontier) < m:
            branches = [r for r in frontier if self._child_count[r] > 0]
            if not branches:
                break
            big = max(branches, key=lambda r: (sizes[r], -r))
            frontier.remove(big)
            frontier.extend(self.children_of(big))
        bins: list[list[int]] = [[] for _ in range(m)]
        loads = [0] * m
        for r in sorted(frontier, key=lambda r: (-sizes[r], r)):
            i = min(range(m), key=lambda j: (loads[j], j))
            bins[i].append(r)
            loads[i] += int(sizes[r])
        return [sorted(b) for b in bins if b]

    def shard(self, m: int) -> list["NodeTable"]:
        """Partition the table into at most ``m`` sub-tables of balanced
        point count (the distributed engine's per-shard tables).

        The root's child subtrees form the starting units — for a
        :meth:`merged` table these are exactly the per-server subspaces, so
        the central SplitTree's partition is recovered verbatim when ``m``
        matches the server count.  While there are fewer units than shards
        the largest unit is split into its children, then units are packed
        into ``m`` bins by greedy longest-processing-time assignment.  Fewer
        than ``m`` shards come back when the tree cannot be cut that finely
        (e.g. a single-leaf table).  Deterministic for a given table.
        """
        if m == 1:
            return [self]
        sizes = self.subtree_points()
        return [
            self.subtable(b, sizes=sizes) for b in self.shard_plan(m, sizes)
        ]

    # -- grid-index bridge -----------------------------------------------------
    def to_grid_index(self, points: np.ndarray, dtype=np.float32):
        """Re-lay the leaf level into the ``GridIndex`` grid (serving layout),
        as host tensors; the caller moves it to the card (``.to``).

        The table's leaf-contiguous ``perm`` *is* the sorted point order
        the grid wants; leaves are padded to a uniform slot count with
        sentinel rows (``row_id = -1``, coords at dtype-max) and the leaf
        count to a power of two with empty boxes (``lo = +max``,
        ``hi = -max``, whose mindist overflows to ``+inf``).  Only the leaf
        gather runs here: no rebuild, no re-sort.  An FMBI tree has no
        balanced split tables, so ``grid_index.route`` is not meaningful on
        a bridged index; use ``grid_index.nearest_leaf``.
        """
        import torch

        from .grid_index import GridIndex  # function-local: it imports the engine

        if bool(self.unrefined.any()):
            raise ValueError("bridge requires a fully refined table")
        rows = self.leaf_rows()
        counts = self.leaf_count[rows]
        l_real = len(rows)
        leaf_size = int(counts.max()) if l_real else 1
        n_leaves = 1
        while n_leaves < l_real:
            n_leaves *= 2
        levels = n_leaves.bit_length() - 1
        d = points.shape[1]
        big = np.finfo(dtype).max
        grid = np.full((n_leaves * leaf_size, d), big, dtype=dtype)
        ids = np.full(n_leaves * leaf_size, -1, dtype=np.int32)
        sel = ragged_ranges(self.leaf_start[rows], counts)
        within = np.arange(len(sel), dtype=np.int64) - np.repeat(
            np.cumsum(counts) - counts, counts
        )
        slot = np.repeat(np.arange(l_real, dtype=np.int64) * leaf_size, counts) + within
        data_rows = self.perm[sel]
        grid[slot] = points[data_rows].astype(dtype)
        ids[slot] = data_rows
        leaf_lo = np.full((n_leaves, d), big, dtype=dtype)
        leaf_hi = np.full((n_leaves, d), -big, dtype=dtype)
        leaf_lo[:l_real] = self.mbb_lo[rows]
        leaf_hi[:l_real] = self.mbb_hi[rows]
        lv = max(levels, 1)
        return GridIndex(
            points_sorted=torch.from_numpy(grid),
            row_ids=torch.from_numpy(ids),
            split_dim=torch.zeros((lv, n_leaves), dtype=torch.int32),
            split_val=torch.from_numpy(np.full((lv, n_leaves), np.inf, dtype=dtype)),
            leaf_lo=torch.from_numpy(leaf_lo),
            leaf_hi=torch.from_numpy(leaf_hi),
            levels=levels,
            leaf_size=leaf_size,
        )

    # -- device layout --------------------------------------------------------
    def pack_leaf_blocks(
        self, rows: np.ndarray, points: np.ndarray, S: int, dtype=np.float32
    ) -> tuple[np.ndarray, np.ndarray]:
        """Uniform ``S``-slot point/id blocks for the given payload rows
        (padding slots carry ``id = -1`` and dtype-max coordinates).  The
        device export and the incremental delta refresh share this packing.
        """
        d = self.dim
        big = np.finfo(dtype).max
        k = len(rows)
        counts = self.leaf_count[rows]
        leaf_pts = np.full((k, S, d), big, dtype=dtype)
        leaf_ids = np.full((k, S), -1, dtype=np.int32)
        if k:
            sel = ragged_ranges(self.leaf_start[rows], counts)
            within = np.arange(len(sel), dtype=np.int64) - np.repeat(
                np.cumsum(counts) - counts, counts
            )
            slot_l = np.repeat(np.arange(k, dtype=np.int64), counts)
            data_rows = self.perm[sel]
            leaf_pts[slot_l, within] = points[data_rows].astype(dtype)
            leaf_ids[slot_l, within] = data_rows
        return leaf_pts, leaf_ids

    def slot_map(
        self, leaf_rows: np.ndarray, cold_rows: np.ndarray
    ) -> np.ndarray:
        """Per-row frontier slots: leaves take ``[0, L)`` in ``leaf_rows``
        order, cold (unrefined) rows ``[L, L + U)``, branches the dropped
        sentinel ``L + U``.  One encoding shared by the full export and
        the incremental delta refresh."""
        L, U = len(leaf_rows), len(cold_rows)
        slot_of = np.full(self._n, L + U, dtype=np.int64)
        slot_of[leaf_rows] = np.arange(L)
        slot_of[cold_rows] = L + np.arange(U)
        return slot_of

    def level_blocks(self, slot_of: np.ndarray, dtype=np.float32) -> list:
        """BFS level blocks for the frontier descent: per depth, row MBBs,
        each row's parent *position* within the previous level's block, and
        the row's slot from ``slot_of`` (leaf slot, cold slot, or the
        dropped sentinel for branches)."""
        pos = np.zeros(self._n, dtype=np.int64)
        levels: list[dict] = []
        cur = np.zeros(1, dtype=np.int64)
        parent_pos = np.zeros(1, dtype=np.int64)
        while cur.size:
            pos[cur] = np.arange(cur.size)
            levels.append(
                {
                    "lo": self.mbb_lo[cur].astype(dtype),
                    "hi": self.mbb_hi[cur].astype(dtype),
                    "parent": parent_pos.astype(np.int32),
                    "slot": slot_of[cur].astype(np.int32),
                }
            )
            cc = self.child_count[cur]
            nxt = ragged_ranges(self.first_child[cur], cc)
            parent_pos = pos[np.repeat(cur, cc)]
            cur = nxt
        return levels

    def device_layout(
        self, points: np.ndarray, dtype=np.float32, *,
        partial: bool = False, compressed: bool = False,
    ) -> dict:
        """Fixed-shape arrays for the device query engine (numpy side).

        The ragged table is re-blocked so every shape is static and every
        query-time access is a dense gather (see ``core/queries_torch.py``,
        which uploads these arrays into a ``DeviceTable``):

          * ``leaf_pts``/``leaf_ids``  (L, S, d)/(L, S): each leaf's points
            gathered once through ``perm`` into uniform ``S``-slot blocks
            (S = max leaf fullness; padding slots carry ``id = -1`` and
            dtype-max coordinates so containment and distance tests mask
            them for free);
          * ``leaf_lo``/``leaf_hi``  (L, d): leaf MBBs, slot-aligned;
          * ``levels``: one block per tree depth — row MBBs, each row's
            parent *position* within the previous level's block, and the
            row's slot: leaf slot, ``L + cold slot`` for unrefined rows,
            or the dropped sentinel ``L + U`` for branches.  Level blocks
            drive the masked level-synchronous frontier descent; BFS order
            is computed here so grafted (AMBI-refined) tables, whose rows
            are not level-contiguous, lay out identically to freshly built
            ones.

        With ``partial=False`` (default) the table must be fully refined:
        an unrefined row has no subtree to descend and its raw pages live
        host-side only.  With ``partial=True`` unrefined rows are exported
        as *cold* entries — their MBBs land in ``cold_lo``/``cold_hi`` and
        their slots in the level blocks address the cold range, so the
        frontier traversal surfaces "this query reaches unindexed space"
        as a mask the serving layer answers host-side (refining on
        demand).  ``leaf_rows``/``cold_rows`` map slots back to table rows
        (the scaffolding the incremental delta refresh rebases).

        With ``compressed=True`` the layout also carries outward-rounded
        bfloat16 copies of every bound column (:func:`compress_boxes_bf16`,
        as ``np.uint16`` bit patterns):
        ``leaf_lo_c``/``leaf_hi_c`` beside the leaf MBBs and ``lo_c``/
        ``hi_c`` inside each level block.  The compressed boxes contain
        their f32 originals, so traversal against them can only *add*
        candidates; the f32 columns stay alongside for the engine's
        certified re-check, keeping results id-identical at half the
        bound-column bandwidth.
        """
        if not partial and bool(self.unrefined.any()):
            raise ValueError(
                "device layout requires a fully refined table "
                "(pass partial=True to export unrefined rows as cold)"
            )
        rows = self.leaf_rows()
        cold = np.flatnonzero(self.unrefined)
        counts = self.leaf_count[rows]
        L = len(rows)
        S = max(int(counts.max()) if L and counts.size else 1, 1)
        leaf_pts, leaf_ids = self.pack_leaf_blocks(rows, points, S, dtype)
        slot_of = self.slot_map(rows, cold)
        levels = self.level_blocks(slot_of, dtype)
        layout = {
            "leaf_pts": leaf_pts,
            "leaf_ids": leaf_ids,
            "leaf_counts": counts.astype(np.int32),
            "leaf_lo": self.mbb_lo[rows].astype(dtype),
            "leaf_hi": self.mbb_hi[rows].astype(dtype),
            "cold_lo": self.mbb_lo[cold].astype(dtype),
            "cold_hi": self.mbb_hi[cold].astype(dtype),
            "levels": levels,
            "leaf_rows": rows,
            "cold_rows": cold,
        }
        if compressed:
            layout["leaf_lo_c"], layout["leaf_hi_c"] = compress_boxes_bf16(
                layout["leaf_lo"], layout["leaf_hi"]
            )
            for lv in levels:
                lv["lo_c"], lv["hi_c"] = compress_boxes_bf16(
                    lv["lo"], lv["hi"]
                )
        return layout

    def to_device(self, points: np.ndarray, *, compressed: bool = False,
                  device=None):
        """Upload :meth:`device_layout` into the CUDA engine's ``DeviceTable``
        (``device="cpu"`` keeps it on the host for the plain versions)."""
        from .queries_torch import DeviceTable

        return DeviceTable.from_table(
            self, points, compressed=compressed, device=device
        )

    # -- invariants ----------------------------------------------------------
    def check_invariants(self, n_points: Optional[int] = None) -> None:
        """Assert the structural invariants every layer relies on."""
        n = self._n
        assert n >= 1, "empty table"
        fc, cc = self.first_child, self.child_count
        branches = np.flatnonzero(cc > 0)
        # CSR ranges stay inside the table and cover every non-root row once
        assert np.all(fc[branches] >= 1)
        assert np.all(fc[branches] + cc[branches] <= n)
        seen = np.zeros(n, dtype=np.int64)
        for r in branches:
            seen[fc[r] : fc[r] + cc[r]] += 1
        assert np.all(seen[1:] == 1), "child ranges must partition rows 1..N"
        assert seen[0] == 0, "root must not be a child"
        # leaf/unrefined perm ranges: in bounds, disjoint, and together a
        # permutation of the dataset rows (dead segments from grafts allowed)
        payload = np.flatnonzero(self.leaf_start >= 0)
        ls, lcnt = self.leaf_start[payload], self.leaf_count[payload]
        assert np.all(ls + lcnt <= self._np)
        sel = ragged_ranges(ls, lcnt)
        assert len(np.unique(sel)) == len(sel), "live perm segments overlap"
        vals = self.perm[sel]
        assert len(np.unique(vals)) == len(vals), "duplicate dataset rows"
        if n_points is not None:
            assert len(vals) == n_points
            assert vals.min(initial=0) >= 0
            if len(vals):
                assert vals.max() < n_points
        # parent MBBs contain child MBBs
        if len(branches):
            kids = ragged_ranges(fc[branches], cc[branches])
            par = np.repeat(branches, cc[branches])
            assert np.all(self.mbb_lo[par] <= self.mbb_lo[kids] + 1e-12)
            assert np.all(self.mbb_hi[par] >= self.mbb_hi[kids] - 1e-12)


# --------------------------------------------------------------------------
# thin read-only object view (tests / metrics / examples walk this)
# --------------------------------------------------------------------------
class NodeView:
    """Read-only ``Node``-shaped view over one table row."""

    __slots__ = ("_t", "row")

    def __init__(self, table: NodeTable, row: int):
        self._t = table
        self.row = int(row)

    @property
    def mbb(self) -> np.ndarray:
        return np.stack([self._t.mbb_lo[self.row], self._t.mbb_hi[self.row]])

    @property
    def page_id(self) -> int:
        return int(self._t.page_id[self.row])

    @property
    def is_leaf(self) -> bool:
        return bool(
            self._t.leaf_start[self.row] >= 0 and not self._t.unrefined[self.row]
        )

    @property
    def is_unrefined(self) -> bool:
        return bool(self._t.unrefined[self.row])

    @property
    def point_idx(self) -> Optional[np.ndarray]:
        return self._t.point_rows(self.row) if self.is_leaf else None

    @property
    def raw_points(self) -> Optional[np.ndarray]:
        return self._t.point_rows(self.row) if self.is_unrefined else None

    @property
    def raw_pages(self) -> int:
        return int(self._t.raw_pages[self.row])

    @property
    def children(self) -> Optional[list["NodeView"]]:
        if self._t.leaf_start[self.row] >= 0:
            return None
        return [NodeView(self._t, r) for r in self._t.children_of(self.row)]

    def n_entries(self) -> int:
        if self.is_leaf:
            return int(self._t.leaf_count[self.row])
        if self.is_unrefined:
            return int(self._t.raw_pages[self.row])
        return int(self._t.child_count[self.row])

    def iter_leaves(self):
        t = self._t
        stack = [self.row]
        while stack:
            r = stack.pop()
            if t.leaf_start[r] >= 0:
                if not t.unrefined[r]:
                    yield NodeView(t, r)
            else:
                stack.extend(t.children_of(r))
