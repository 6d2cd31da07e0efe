"""State carried across from the JAX package: its ``NodeTable`` columns
(or a whole index), or the six arrays of its ``JaxIndex``, become this
package's objects.

The JAX package's table is plain NumPy structure-of-arrays, so carrying it
across is a copy of ten columns; a ``JaxIndex`` is six arrays and two
integers.  No module of that package is imported.
A snapshot that its ``NodeTable.save`` wrote loads directly through
:meth:`.nodetable.NodeTable.load` (same ``.npz`` format).
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

import torch

from .fmbi import Index
from .grid_index import GridIndex
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


def grid_index_from_arrays(arrays: Mapping[str, np.ndarray], levels: int,
                           leaf_size: int) -> GridIndex:
    """A host ``GridIndex`` from another index's six arrays
    (``points_sorted``, ``row_ids``, ``split_dim``, ``split_val``,
    ``leaf_lo``, ``leaf_hi``, as NumPy) and its ``levels``/``leaf_size``;
    the caller moves it to the card (``.to``).  Raises on a missing array
    or a shape that disagrees with ``levels`` and ``leaf_size``."""
    missing = [a for a in GridIndex.ARRAYS if a not in arrays]
    if missing:
        raise ValueError(f"missing index arrays: {missing}")
    cols = {a: np.array(arrays[a], order="C") for a in GridIndex.ARRAYS}  # own copies
    n_leaves = 1 << levels
    n, d = cols["points_sorted"].shape
    want = {"points_sorted": (n_leaves * leaf_size, d),
            "row_ids": (n_leaves * leaf_size,),
            "leaf_lo": (n_leaves, d), "leaf_hi": (n_leaves, d)}
    for a, shape in want.items():
        if cols[a].shape != shape:
            raise ValueError(f"{a} has shape {cols[a].shape}, expected {shape}")
    if cols["split_dim"].shape != cols["split_val"].shape or \
            cols["split_dim"].shape[0] < levels:
        raise ValueError(f"split tables of shapes {cols['split_dim'].shape} and "
                         f"{cols['split_val'].shape} do not cover {levels} levels")
    cols["row_ids"] = cols["row_ids"].astype(np.int32)
    cols["split_dim"] = cols["split_dim"].astype(np.int32)
    return GridIndex(**{a: torch.from_numpy(v) for a, v in cols.items()},
                     levels=int(levels), leaf_size=int(leaf_size))
