"""Index quality metrics: the paper's Table 1 / Figure 4 statistics.

Computed straight off the flat :class:`.nodetable.NodeTable` —
leaf extents, fills, and subtree cardinalities are column reductions, not
object-graph walks.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .fmbi import Index


@dataclasses.dataclass
class LeafStats:
    count: int
    total_area: float       # sum over leaves of prod(side lengths)
    total_perimeter: float  # 2 * sum of side lengths per leaf (2D perimeter;
                            # for d>2 this is the paper's analogous L1 margin)
    avg_fill: float         # points per leaf / leaf capacity
    max_over_mean: float    # subspace balance (paper Fig 4a: 1.06 for OSM)
    min_over_mean: float

    def as_row(self) -> dict:
        return dataclasses.asdict(self)


def leaf_stats(index: Index) -> LeafStats:
    t = index.table
    rows = t.leaf_rows()
    ext = t.mbb_hi[rows] - t.mbb_lo[rows]
    count = len(rows)
    sides_sum = float(ext.sum())
    area_sum = float(np.prod(ext, axis=1).sum()) if count else 0.0
    fill = float(t.leaf_count[rows].sum()) / (max(count, 1) * index.leaf_cap)
    # root-entry balance (Fig 4a): points under each child of the root
    # (unrefined subtrees count their raw ranges)
    if t.child_count[0] > 0:
        subtree = t.subtree_points()
        sizes = subtree[
            t.first_child[0] : t.first_child[0] + t.child_count[0]
        ].astype(np.float64)
    else:
        sizes = np.asarray([1.0])
    mean = sizes.mean() if sizes.size else 1.0
    return LeafStats(
        count=count,
        total_area=area_sum,
        total_perimeter=2.0 * sides_sum,
        avg_fill=fill,
        max_over_mean=float(sizes.max() / mean),
        min_over_mean=float(sizes.min() / mean),
    )


def overlap_area_2d(index: Index) -> float:
    """Total pairwise overlap area of sibling leaf MBBs (0 for FMBI by
    construction; positive for Hilbert packing)."""
    t = index.table
    rows = t.leaf_rows()
    if len(rows) == 0 or index.dim != 2:
        return 0.0
    los, his = t.mbb_lo[rows], t.mbb_hi[rows]
    n = len(rows)
    total = 0.0
    for i in range(n):
        j = slice(i + 1, n)
        lo = np.maximum(los[j], los[i])
        hi = np.minimum(his[j], his[i])
        ext = np.clip(hi - lo, 0.0, None)
        total += float(np.prod(ext, axis=1).sum())
    return total
