"""State carried across from the JAX package: its ``NodeTable`` columns
(or a whole index) become this package's objects.

The JAX package's table is plain NumPy structure-of-arrays, so carrying it
across is a copy of ten columns; no module of that package is imported.
A snapshot that its ``NodeTable.save`` wrote loads directly through
:meth:`.nodetable.NodeTable.load` (same ``.npz`` format).
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from .fmbi import Index
from .nodetable import NodeTable
from .pagestore import PageStore, branch_capacity, leaf_capacity

_DTYPES = {
    "mbb_lo": np.float64, "mbb_hi": np.float64, "page_id": np.int64,
    "first_child": np.int64, "child_count": np.int64, "leaf_start": np.int64,
    "leaf_count": np.int64, "raw_pages": np.int64, "unrefined": np.bool_,
    "perm": np.int64,
}


def table_from_arrays(dim: int, columns: Mapping[str, np.ndarray]) -> NodeTable:
    """This package's ``NodeTable`` from the ten SoA columns of another
    table (``mbb_lo``, ``mbb_hi``, ``page_id``, ``first_child``,
    ``child_count``, ``leaf_start``, ``leaf_count``, ``raw_pages``,
    ``unrefined``, ``perm``).  Raises on a missing column or a column
    whose length or width disagrees with the others."""
    missing = [c for c in NodeTable.COLUMNS if c not in columns]
    if missing:
        raise ValueError(f"missing table columns: {missing}")
    cols = {c: np.asarray(columns[c], dtype=_DTYPES[c]) for c in NodeTable.COLUMNS}
    n = len(cols["page_id"])
    for c in NodeTable.COLUMNS:
        if c == "perm":
            continue
        if len(cols[c]) != n:
            raise ValueError(f"column {c} has {len(cols[c])} rows, expected {n}")
    for c in ("mbb_lo", "mbb_hi"):
        if cols[c].shape != (n, dim):
            raise ValueError(f"column {c} has shape {cols[c].shape}, expected {(n, dim)}")
    return NodeTable.from_columns(dim, cols)


def index_from_arrays(columns: Mapping[str, np.ndarray], points: np.ndarray, *,
                      buffer_pages: int = 64,
                      next_page_id: Optional[int] = None) -> Index:
    """This package's ``Index`` over ``points`` from another index's table
    columns, with a fresh (cold) ``PageStore`` of ``buffer_pages`` whose
    page allocator continues after ``next_page_id`` (default: one past the
    largest page id in the table)."""
    points = np.asarray(points)
    d = points.shape[1]
    table = table_from_arrays(d, columns)
    store = PageStore(int(buffer_pages))
    if next_page_id is None:
        next_page_id = int(table.page_id.max()) + 1 if table.n_nodes else 0
    store.mark_allocated(int(next_page_id))
    return Index(table, d, leaf_capacity(d), branch_capacity(d), store, points)
