"""Competitor bulk loaders (paper Section 2.1), in the unified framework.

Every loader physically builds the same ``Node`` tree (so query processing
and the Table-1 leaf statistics are measured on the real structure) while
charging construction I/O to the shared ``PageStore`` according to each
method's disk access pattern:

  * hilbert  — Kamel & Faloutsos packing: ONE external sort by Hilbert rank,
               pack leaves, build upper levels bottom-up.
  * str      — Leutenegger et al.: sort-and-tile, one sorting round per
               dimension (later rounds run per-slice, usually in-buffer).
  * omt      — Lee & Lee: top-down STR variant driven by the height formula;
               re-sorts at every tree level -> more expensive than STR.
  * kdb      — Spread KDB-tree bulk load (top-down median splits at *entry*
               granularity: leaves are not packed, ~1.4x the leaf count).
  * waffle   — bottom-up median splits at page boundaries to single pages,
               then upper levels reuse the splits (query-optimal structure,
               but one sorting pass per recursion level -> slow build).

Sorting subsets larger than the buffer is charged as textbook external merge
sort; subsets that fit in the buffer are read once and processed in memory —
the same accounting the paper applies in its Rust framework.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .fmbi import Index, Node
from .hilbert import hilbert_sort
from .pagestore import PageStore, branch_capacity, leaf_capacity
from .splittree import longest_dimension, mbb_of


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------
def _leaf(points, idx, store) -> Node:
    page = store.alloc()
    store.write(page)
    return Node(mbb=mbb_of(points[idx]), page_id=page, point_idx=idx)


def _branch(children, store) -> Node:
    page = store.alloc()
    store.write(page)
    mbb = np.stack(
        [
            np.min([c.mbb[0] for c in children], axis=0),
            np.max([c.mbb[1] for c in children], axis=0),
        ]
    )
    return Node(mbb=mbb, page_id=page, children=children)


def _pack_leaves(points, idx_sorted, leaf_cap, store) -> list[Node]:
    return [
        _leaf(points, idx_sorted[i : i + leaf_cap], store)
        for i in range(0, len(idx_sorted), leaf_cap)
    ]


def _group_upper(nodes, branch_cap, store, order=None) -> Node:
    """Build upper levels by grouping ``branch_cap`` consecutive nodes."""
    while len(nodes) > 1:
        if order is not None:
            centers = np.stack([(n.mbb[0] + n.mbb[1]) / 2 for n in nodes])
            nodes = [nodes[i] for i in order(centers)]
        nodes = [
            _branch(nodes[i : i + branch_cap], store)
            for i in range(0, len(nodes), branch_cap)
        ]
    return nodes[0]


def _charge_sort(store: PageStore, pages: int, buffer_pages: int) -> None:
    store.charge(store.external_sort_cost(pages, buffer_pages))


# --------------------------------------------------------------------------
# Hilbert packing
# --------------------------------------------------------------------------
def bulk_load_hilbert(
    points: np.ndarray, buffer_pages: int, store: Optional[PageStore] = None
) -> Index:
    store = store or PageStore(buffer_pages)
    n, d = points.shape
    c_l, c_b = leaf_capacity(d), branch_capacity(d)
    p = -(-n // c_l)
    # one external sort of the whole file by Hilbert rank
    _charge_sort(store, p, buffer_pages)
    order = hilbert_sort(points)
    leaves = _pack_leaves(points, order, c_l, store)

    def center_order(centers):
        return hilbert_sort(centers)

    root = _group_upper(leaves, c_b, store, order=center_order)
    return Index(root, d, c_l, c_b, store, points)


# --------------------------------------------------------------------------
# STR
# --------------------------------------------------------------------------
def bulk_load_str(
    points: np.ndarray, buffer_pages: int, store: Optional[PageStore] = None
) -> Index:
    store = store or PageStore(buffer_pages)
    n, d = points.shape
    c_l, c_b = leaf_capacity(d), branch_capacity(d)

    def tile(idx: np.ndarray, dims: list[int], unit: int, in_memory: bool):
        """Recursive sort-and-tile; ``unit`` = points per packed unit."""
        pages = -(-len(idx) // c_l)
        if not in_memory:
            if pages <= buffer_pages:
                store.read_run(pages)
                in_memory = True
            else:
                _charge_sort(store, pages, buffer_pages)
        if len(dims) == 1 or len(idx) <= unit:
            order = np.argsort(points[idx, dims[0]], kind="stable")
            si = idx[order]
            return [si[i : i + unit] for i in range(0, len(si), unit)]
        n_units = -(-len(idx) // unit)
        slices = math.ceil(n_units ** (1.0 / len(dims)))
        per_slice = -(-n_units // slices) * unit
        order = np.argsort(points[idx, dims[0]], kind="stable")
        si = idx[order]
        out = []
        for i in range(0, len(si), per_slice):
            out.extend(tile(si[i : i + per_slice], dims[1:], unit, in_memory))
        return out

    chunks = tile(np.arange(n), list(range(d)), c_l, in_memory=False)
    leaves = [_leaf(points, c, store) for c in chunks]

    # upper levels: STR over node centers (fits in memory at these scales)
    nodes = leaves
    while len(nodes) > 1:
        centers = np.stack([(nd.mbb[0] + nd.mbb[1]) / 2 for nd in nodes])
        groups = _str_tile_centers(centers, list(range(d)), c_b)
        nodes = [_branch([nodes[i] for i in g], store) for g in groups]
    return Index(nodes[0], d, c_l, c_b, store, points)


def _str_tile_centers(centers, dims, unit) -> list[list[int]]:
    def rec(idx, dims):
        if len(dims) == 1 or len(idx) <= unit:
            order = np.argsort(centers[idx, dims[0]], kind="stable")
            si = idx[order]
            return [list(si[i : i + unit]) for i in range(0, len(si), unit)]
        n_units = -(-len(idx) // unit)
        slices = math.ceil(n_units ** (1.0 / len(dims)))
        per_slice = -(-n_units // slices) * unit
        order = np.argsort(centers[idx, dims[0]], kind="stable")
        si = idx[order]
        out = []
        for i in range(0, len(si), per_slice):
            out.extend(rec(si[i : i + per_slice], dims[1:]))
        return out

    return rec(np.arange(len(centers)), dims)


# --------------------------------------------------------------------------
# OMT
# --------------------------------------------------------------------------
def bulk_load_omt(
    points: np.ndarray, buffer_pages: int, store: Optional[PageStore] = None
) -> Index:
    store = store or PageStore(buffer_pages)
    n, d = points.shape
    c_l, c_b = leaf_capacity(d), branch_capacity(d)

    def rec(idx: np.ndarray, in_memory: bool) -> Node:
        pages = -(-len(idx) // c_l)
        if not in_memory:
            if pages <= buffer_pages:
                store.read_run(pages)
                in_memory = True
        if pages <= 1:
            return _leaf(points, idx, store)
        h = max(1, math.ceil(math.log(pages, c_b)))
        p_child = c_b ** (h - 1)
        n_child = -(-pages // p_child)

        def tile(sub: np.ndarray, dims: list[int], want: int) -> list[np.ndarray]:
            if want <= 1 or len(dims) == 0:
                return [sub]
            sub_pages = -(-len(sub) // c_l)
            if not in_memory and sub_pages > buffer_pages:
                _charge_sort(store, sub_pages, buffer_pages)
            t = max(1, math.floor(want ** (1.0 / len(dims))))
            if t <= 1:
                t = min(want, 2)
            order = np.argsort(points[sub, dims[0]], kind="stable")
            ss = sub[order]
            unit = -(-sub_pages // t) * c_l
            out = []
            for i in range(0, len(ss), unit):
                out.extend(tile(ss[i : i + unit], dims[1:], -(-want // t)))
            return out

        parts = tile(idx, list(range(d)), n_child)
        children = [rec(p, in_memory) for p in parts if len(p)]
        if len(children) == 1:
            return children[0]
        return _branch(children, store)

    return Index(rec(np.arange(n), False), d, c_l, c_b, store, points)


# --------------------------------------------------------------------------
# Spread KDB-tree (bulk load of [24], spread split dimension)
# --------------------------------------------------------------------------
def bulk_load_kdb(
    points: np.ndarray, buffer_pages: int, store: Optional[PageStore] = None
) -> Index:
    store = store or PageStore(buffer_pages)
    n, d = points.shape
    c_l, c_b = leaf_capacity(d), branch_capacity(d)

    def rec(idx: np.ndarray, in_memory: bool) -> list[Node]:
        pages = -(-len(idx) // c_l)
        if not in_memory:
            if pages <= buffer_pages:
                store.read_run(pages)
                in_memory = True
            else:
                _charge_sort(store, pages, buffer_pages)
        if len(idx) <= c_l:
            return [_leaf(points, idx, store)]
        dim = longest_dimension(points[idx])
        order = np.argsort(points[idx, dim], kind="stable")
        half = len(idx) // 2  # median *entry* split: leaves end up ~3/4 full
        left = rec(idx[order[:half]], in_memory)
        right = rec(idx[order[half:]], in_memory)
        both = left + right
        if len(both) <= c_b:
            return both
        return [_branch(left, store), _branch(right, store)]

    entries = rec(np.arange(n), False)
    root = entries[0] if len(entries) == 1 else _branch(entries, store)
    return Index(root, d, c_l, c_b, store, points)


# --------------------------------------------------------------------------
# Waffle bulk loading (bottom-up, page-boundary median splits)
# --------------------------------------------------------------------------
def bulk_load_waffle(
    points: np.ndarray, buffer_pages: int, store: Optional[PageStore] = None
) -> Index:
    store = store or PageStore(buffer_pages)
    n, d = points.shape
    c_l, c_b = leaf_capacity(d), branch_capacity(d)

    def rec(idx: np.ndarray, in_memory: bool) -> list[Node]:
        pages = -(-len(idx) // c_l)
        if not in_memory:
            if pages <= buffer_pages:
                store.read_run(pages)
                in_memory = True
            else:
                # Waffle sorts the subset to find the page-boundary median
                _charge_sort(store, pages, buffer_pages)
        if pages <= 1:
            return [_leaf(points, idx, store)]
        dim = longest_dimension(points[idx])
        order = np.argsort(points[idx, dim], kind="stable")
        # split entry ranked C_L * ⌊⌈N/C_L⌉ / 2⌋  (paper Section 2.1)
        cut = c_l * (pages // 2)
        left = rec(idx[order[:cut]], in_memory)
        right = rec(idx[order[cut:]], in_memory)
        both = left + right
        if len(both) <= c_b:
            return both
        return [_branch(left, store), _branch(right, store)]

    entries = rec(np.arange(n), False)
    root = entries[0] if len(entries) == 1 else _branch(entries, store)
    return Index(root, d, c_l, c_b, store, points)


LOADERS = {
    "hilbert": bulk_load_hilbert,
    "str": bulk_load_str,
    "omt": bulk_load_omt,
    "kdb": bulk_load_kdb,
    "waffle": bulk_load_waffle,
}
