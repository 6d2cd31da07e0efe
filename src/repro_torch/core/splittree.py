"""SplitTrees (Major and minor), array-encoded for vectorized traversal.

The paper's MST/mST are binary trees of (dimension, value) splits produced by
recursive median partitioning on the longest (highest-spread) dimension.  We
encode a tree as flat int/float arrays so that point->subspace routing is a
data-parallel gather loop — the form consumed by ``kernels/partition_assign``
(Pallas) and by ``numpy``/``jnp`` reference traversals.

Encoding (node 0 is the root; n internal nodes, n+1 leaves):
  split_dim[i]  int32   dimension of split i
  split_val[i]  float32 coordinate of split i
  left[i], right[i] int32: >= 0 -> internal node index;
                            < 0  -> leaf (subspace) id = -(x) - 1
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


@dataclasses.dataclass
class FlatSplitTree:
    split_dim: np.ndarray  # (n,) int32
    split_val: np.ndarray  # (n,) float32
    left: np.ndarray       # (n,) int32
    right: np.ndarray      # (n,) int32
    n_leaves: int

    @property
    def n_splits(self) -> int:
        return int(self.split_dim.shape[0])

    def route(self, points: np.ndarray) -> np.ndarray:
        """Vectorized point -> leaf-id routing (numpy reference).

        Points within the right half-open interval go right:
        ``p[dim] > val -> right`` (points equal to the split value stay left,
        matching the paper's 'last point of the median page' convention).
        """
        n = points.shape[0]
        if self.n_splits == 0:
            return np.zeros(n, dtype=np.int32)
        # Full-width descent: every level is a handful of O(n) gathers with
        # no per-level subset compaction (the tree is balanced, so the loop
        # runs ~log2(n_leaves) times and finished lanes just idle).
        node = np.zeros(n, dtype=np.int32)   # current internal node
        out = np.full(n, -1, dtype=np.int32)
        done = np.zeros(n, dtype=bool)
        for _ in range(self.n_splits + 1):
            d = self.split_dim[node]
            v = self.split_val[node]
            coord = np.take_along_axis(points, d[:, None].astype(np.intp), 1)[:, 0]
            nxt = np.where(coord > v, self.right[node], self.left[node])
            leaf = (nxt < 0) & ~done
            out[leaf] = -nxt[leaf] - 1
            done |= leaf
            node = np.where(done, node, nxt)
            if done.all():
                break
        return out


class _TreeBuilder:
    def __init__(self):
        self.split_dim: list[int] = []
        self.split_val: list[float] = []
        self.left: list[int] = []
        self.right: list[int] = []
        self.leaf_payload: list = []

    def add_split(self, dim: int, val: float) -> int:
        i = len(self.split_dim)
        self.split_dim.append(dim)
        self.split_val.append(val)
        self.left.append(0)
        self.right.append(0)
        return i

    def add_leaf(self, payload) -> int:
        self.leaf_payload.append(payload)
        return -(len(self.leaf_payload) - 1) - 1

    def finish(self) -> tuple[FlatSplitTree, list]:
        tree = FlatSplitTree(
            split_dim=np.asarray(self.split_dim, dtype=np.int32),
            split_val=np.asarray(self.split_val, dtype=np.float32),
            left=np.asarray(self.left, dtype=np.int32),
            right=np.asarray(self.right, dtype=np.int32),
            n_leaves=len(self.leaf_payload),
        )
        return tree, self.leaf_payload


def longest_dimension(points: np.ndarray) -> int:
    """Dimension with the highest data spread (Spread-KDB convention, which
    the paper adopts for its median splits)."""
    if points.shape[0] == 0:
        return 0
    spread = points.max(axis=0) - points.min(axis=0)
    return int(np.argmax(spread))


def build_group_median_tree(
    points: np.ndarray,
    n_groups: int,
    group_pages: int,
    page_points: int,
    on_leaf: Callable[[np.ndarray, int], object] | None = None,
) -> tuple[FlatSplitTree, list, np.ndarray]:
    """Step-1 Major SplitTree construction.

    ``points`` are the sampled ``alpha * C_B`` pages' points.  The tree
    recursively splits the *page-group count* at the median group boundary —
    splitting a region of ``k`` groups (each group = ``group_pages`` full
    pages = ``group_pages * page_points`` points) into ⌊k/2⌋ and ⌈k/2⌉ groups
    — until every region holds exactly one group.  This is the paper's
    "split at the last point of the ⌊·/2⌋-th sorted page" rule applied at the
    α-page-group granularity, which is what makes Step 1 terminate with
    exactly C_B subspaces of α full pages each.

    Returns (tree, leaf_payloads, leaf_assignment_for_input_points).
    ``on_leaf(points_of_leaf, leaf_id)`` builds each payload (default: the
    point array itself).
    """
    assert points.shape[0] == n_groups * group_pages * page_points, (
        points.shape,
        n_groups,
        group_pages,
        page_points,
    )
    builder = _TreeBuilder()
    assign = np.empty(points.shape[0], dtype=np.int32)

    def rec(idx: np.ndarray, k: int) -> int:
        pts = points[idx]
        if k == 1:
            leaf_id = len(builder.leaf_payload)
            assign[idx] = leaf_id
            payload = on_leaf(pts, leaf_id) if on_leaf is not None else pts
            return builder.add_leaf(payload)
        dim = longest_dimension(pts)
        order = np.argsort(pts[:, dim], kind="stable")
        kl = k // 2
        cut = kl * group_pages * page_points
        split_val = float(pts[order[cut - 1], dim])
        node = builder.add_split(dim, split_val)
        li = rec(idx[order[:cut]], kl)
        ri = rec(idx[order[cut:]], k - kl)
        builder.left[node] = li
        builder.right[node] = ri
        return node

    root = rec(np.arange(points.shape[0]), n_groups)
    tree, payloads = builder.finish()
    if root < 0:  # degenerate single-leaf tree
        tree = FlatSplitTree(
            split_dim=np.zeros(0, np.int32),
            split_val=np.zeros(0, np.float32),
            left=np.zeros(0, np.int32),
            right=np.zeros(0, np.int32),
            n_leaves=1,
        )
    return tree, payloads, assign


def mbb_of(points: np.ndarray) -> np.ndarray:
    """Minimum bounding box as (2, d): [min; max]."""
    return np.stack([points.min(axis=0), points.max(axis=0)])


def pad_tree(tree: FlatSplitTree, n_splits: int) -> FlatSplitTree:
    """Pad a flat tree to a static size (for fixed-shape kernel launches).

    Padding splits are self-loops routed 'left to a dead leaf'; they are never
    reached because routing starts at node 0 of the real tree.
    """
    n = tree.n_splits
    if n >= n_splits:
        return tree
    pad = n_splits - n
    return FlatSplitTree(
        split_dim=np.concatenate([tree.split_dim, np.zeros(pad, np.int32)]),
        split_val=np.concatenate([tree.split_val, np.full(pad, np.inf, np.float32)]),
        left=np.concatenate([tree.left, np.full(pad, -1, np.int32)]),
        right=np.concatenate([tree.right, np.full(pad, -1, np.int32)]),
        n_leaves=tree.n_leaves,
    )
