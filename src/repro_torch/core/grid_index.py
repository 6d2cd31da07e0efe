"""Balanced grid index of the PyTorch port: device build, routing, window
counts and k-NN.

The port of the JAX package's ``repro/core/jax_index.py``, the accelerator
reformulation of the paper's bulk loader: FMBI's recursive median splits
on the highest-spread dimension, built as ``levels`` rounds of per-group
spread, rank-median split and regrouping over the whole point set at once.
After ``levels`` rounds the points fall into ``2^levels`` equal leaves,
each with a tight box.  The class is :class:`GridIndex` (the JAX package's
``JaxIndex``); every function keeps its JAX name and argument order.

  * ``build``: each round reshapes the points into ``(groups, size, d)``
    (groups are contiguous and equal, as the JAX ``lexsort`` keeps them),
    reduces each group's spread, and sorts each group stably by its split
    coordinate.  It moves no arithmetic beyond one subtraction, so its
    output equals the JAX build's bit for bit.
  * ``route``: point -> leaf through the recorded split tables (FMBI's
    Step-2 loop), on the ``partition_assign`` kernel.
  * ``nearest_leaf``: the leaf of smallest box mindist, on the
    ``leaf_mindist`` kernel; it works on bridged indexes, which carry no
    split tables.
  * ``window_count`` / ``window_count_candidates``: contained leaves add
    their point counts, straddling leaves are gathered and scanned by the
    ``window_count_gathered`` kernel.
  * ``knn``: each query ranks the leaves by mindist (``leaf_mindist``),
    scans its closest ones (``gathered_dist2``) and keeps the top k.

Selections follow ``jax.lax.top_k`` (``ref.top_k``: the lower index first
among equal values, by the float total order), so straddle budgets and
candidate leaves are the JAX package's; the k-NN selections take the
smallest distances directly (``ref.smallest_k``, the reference's
``top_k(-d2)`` without a negation, which on the card would not keep a
NaN's sign).  The device of the index picks the arithmetic: on the card
every kernel launches (or raises), on the CPU the same function runs as
its plain version.  Left out against the JAX module: the ``use_kernel``
switch (the device decides) and ``window_count_traces``, a count of jit
compilations that eager PyTorch does not have.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops
from ..kernels.ref import smallest_k, top_k
from .queries_torch import _pow2, resolve_device


@dataclasses.dataclass
class GridIndex:
    """Array-encoded balanced KD index: ``2^levels`` leaves of
    ``leaf_size`` slots each."""

    points_sorted: torch.Tensor  # (n_pad, d) leaf-contiguous layout
    row_ids: torch.Tensor        # (n_pad,) int32 original row ids (-1 = padding)
    split_dim: torch.Tensor      # (levels, n_groups_max) int32
    split_val: torch.Tensor      # (levels, n_groups_max) float32
    leaf_lo: torch.Tensor        # (n_leaves, d)
    leaf_hi: torch.Tensor        # (n_leaves, d)
    levels: int
    leaf_size: int

    ARRAYS = ("points_sorted", "row_ids", "split_dim", "split_val",
              "leaf_lo", "leaf_hi")

    @property
    def n_leaves(self) -> int:
        return 1 << self.levels

    @property
    def device(self) -> torch.device:
        return self.points_sorted.device

    def to(self, device) -> "GridIndex":
        """A copy of the index on ``device`` (``cuda`` unless named; raises
        without a card)."""
        dev = resolve_device(device)
        arrays = {a: getattr(self, a).to(dev) for a in self.ARRAYS}
        return GridIndex(**arrays, levels=self.levels, leaf_size=self.leaf_size)


def build(points, levels: int, row_ids=None, *, device=None) -> GridIndex:
    """Build the balanced median-split index over ``points`` (n, d), as
    float32, on ``device`` (``cuda`` unless named).

    n must be a multiple of ``2^levels`` (callers pad; see
    :func:`pad_points`).  ``row_ids`` carries the original row identities
    (-1 for padding sentinels)."""
    dev = resolve_device(device)
    pts = torch.as_tensor(points, dtype=torch.float32).to(dev).contiguous()
    n, d = pts.shape
    if row_ids is None:
        rows = torch.arange(n, dtype=torch.int32, device=dev)
    else:
        rows = torch.as_tensor(row_ids).to(device=dev, dtype=torch.int32)
    n_groups_max = 1 << levels
    if n % n_groups_max:
        raise ValueError("pad points to a multiple of 2^levels")
    split_dim = torch.zeros((levels, n_groups_max), dtype=torch.int32, device=dev)
    split_val = torch.full((levels, n_groups_max), float("inf"), device=dev)
    for level in range(levels):
        n_groups = 1 << level
        size = n // n_groups
        grp = pts.view(n_groups, size, d)
        # spread per (group, dim) -> split dimension per group (first max)
        dim_g = torch.argmax(grp.amax(dim=1) - grp.amin(dim=1), dim=1)
        key = torch.gather(grp, 2, dim_g.view(n_groups, 1, 1).expand(n_groups, size, 1))
        key_sorted, order = torch.sort(key.squeeze(2), dim=1, stable=True)
        pts = torch.gather(grp, 1, order.unsqueeze(2).expand(n_groups, size, d))
        pts = pts.reshape(n, d)
        rows = torch.gather(rows.view(n_groups, size), 1, order).reshape(n)
        # split value = key of the last left point per group
        split_dim[level, :n_groups] = dim_g.to(torch.int32)
        split_val[level, :n_groups] = key_sorted[:, size // 2 - 1]
    leaves = pts.view(n_groups_max, n // n_groups_max, d)
    return GridIndex(
        points_sorted=pts,
        row_ids=rows,
        split_dim=split_dim,
        split_val=split_val,
        leaf_lo=leaves.amin(dim=1),
        leaf_hi=leaves.amax(dim=1),
        levels=levels,
        leaf_size=n // n_groups_max,
    )


def pad_points(points: np.ndarray, levels: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad to a multiple of 2^levels with dtype-max sentinels (routed to
    the last leaf; queries mask them via row_ids == -1)."""
    n, d = points.shape
    unit = 1 << levels
    n_pad = -(-n // unit) * unit
    if n_pad == n:
        return points, np.arange(n)
    pad = np.full((n_pad - n, d), np.finfo(points.dtype).max, dtype=points.dtype)
    ids = np.concatenate([np.arange(n), np.full(n_pad - n, -1)])
    return np.concatenate([points, pad]), ids


def _queries(index: GridIndex, x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(index.device).contiguous()


def nearest_leaf(index: GridIndex, queries) -> torch.Tensor:
    """Leaf id with the smallest box mindist per query (the first among
    equal ones; 0 mindist for a containing leaf).  Works on any index,
    including bridged tables, which carry no split tables for ``route``."""
    q = _queries(index, queries)
    mind = ops.leaf_mindist_tiled(q, index.leaf_lo, index.leaf_hi)
    return torch.argmin(mind, dim=1).to(torch.int32)


def route(index: GridIndex, queries) -> torch.Tensor:
    """Leaf id for each query point: the Step-2 routing loop."""
    return ops.partition_assign(_queries(index, queries), index.split_dim,
                                index.split_val, levels=index.levels)


def _leaf_window_masks(index: GridIndex, lo: torch.Tensor, hi: torch.Tensor):
    """(Q, L) masks: leaves intersecting each window, leaves fully inside."""
    inter = contained = None
    for k in range(lo.shape[1]):
        llo = index.leaf_lo[None, :, k]
        lhi = index.leaf_hi[None, :, k]
        qlo = lo[:, k, None]
        qhi = hi[:, k, None]
        i_k = (llo <= qhi) & (lhi >= qlo)
        c_k = (llo >= qlo) & (lhi <= qhi)
        inter = i_k if inter is None else inter & i_k
        contained = c_k if contained is None else contained & c_k
    return inter, contained


def _window_count_core(index: GridIndex, lo, hi, contained, straddle,
                       n_candidate_leaves: int):
    """Counting pass over precomputed (Q, L) leaf masks: contained leaves
    add their valid-point counts, the top ``n_candidate_leaves`` straddling
    leaves are gathered and scanned.  Returns ``(counts, exact)``."""
    n_l, s = index.n_leaves, index.leaf_size
    pts = index.points_sorted.view(n_l, s, -1)
    valid = (index.row_ids >= 0).view(n_l, s)
    per_leaf = valid.sum(dim=1)
    base = torch.where(contained, per_leaf[None], torch.zeros_like(per_leaf)[None]).sum(dim=1)
    c = min(n_candidate_leaves, n_l)
    score, cand = top_k(straddle.to(torch.int32), c)   # (Q, C)
    q = lo.shape[0]
    cand_valid = valid[cand] & (score > 0)[..., None]
    scan = ops.window_count_gathered(
        lo, hi, pts[cand].reshape(q, c * s, -1),
        cand_valid.reshape(q, c * s).to(torch.int32),
    )
    exact = straddle.sum(dim=1) <= c
    return base + scan.to(base.dtype), exact


def window_count_candidates(index: GridIndex, lo, hi, n_candidate_leaves: int):
    """Candidate-leaf window counting: cost scales with the leaves a window
    touches, not with the dataset.

    Only the straddling leaves (the top ``n_candidate_leaves``, rounded up
    to a power of two as the JAX package rounds them) are scanned.  Returns
    ``(counts, exact)``, where ``exact`` certifies that no straddling leaf
    was left unscanned; where it is False the count is a lower bound.  Use
    :func:`window_count` for exact answers."""
    lo, hi = _queries(index, lo), _queries(index, hi)
    inter, contained = _leaf_window_masks(index, lo, hi)
    c = max(1, min(_pow2(n_candidate_leaves), index.n_leaves))
    return _window_count_core(index, lo, hi, contained, inter & ~contained, c)


def window_count(index: GridIndex, lo, hi, n_candidate_leaves: int | None = None):
    """Exact result counts for a batch of windows (Q, d) x 2.

    The candidate budget defaults to the batch's largest number of
    straddling leaves, rounded up to a power of two (one host sync).  An
    explicit ``n_candidate_leaves`` is a starting budget, doubled until
    every window is certified, so the result is exact either way."""
    lo, hi = _queries(index, lo), _queries(index, hi)
    inter, contained = _leaf_window_masks(index, lo, hi)
    straddle = inter & ~contained
    if n_candidate_leaves is None:
        c = _pow2(max(int(straddle.sum(dim=1).max()), 1))
    else:
        c = _pow2(n_candidate_leaves)
    c = max(1, min(c, index.n_leaves))
    while True:
        counts, exact = _window_count_core(index, lo, hi, contained, straddle, c)
        if c >= index.n_leaves or bool(exact.all()):
            return counts
        c = min(c * 2, index.n_leaves)


def knn(index: GridIndex, queries, k: int, n_candidate_leaves: int = 8):
    """Batched k-NN: take the C closest leaves per query (by box mindist),
    scan them exactly and keep the top k.  Returns ``(row_ids, dists_sq,
    exact)``: invalid slots carry distance ``+inf`` (as the JAX package
    returns them), and ``exact`` certifies that the k-th distance does not
    exceed the mindist of the closest unscanned leaf."""
    q = _queries(index, queries)
    n_l, s = index.n_leaves, index.leaf_size
    pts = index.points_sorted.view(n_l, s, -1)
    valid = (index.row_ids >= 0).view(n_l, s)
    rows = index.row_ids.view(n_l, s)
    n_c = min(n_candidate_leaves, n_l)
    nq = q.shape[0]

    mind = ops.leaf_mindist_tiled(q, index.leaf_lo, index.leaf_hi)     # (Q, L)
    mind_sel, cand_all = smallest_k(mind, min(n_c + 1, n_l))
    cand = cand_all[:, :n_c]
    cand_valid = valid[cand].reshape(nq, n_c * s)
    d2 = ops.gathered_dist2(q, pts[cand].reshape(nq, n_c * s, -1),
                            cand_valid.to(torch.int32))
    d2 = torch.where(cand_valid, d2, torch.full_like(d2, float("inf")))
    top_d2, topi = smallest_k(d2, k)
    if n_c == n_l:
        exact = torch.ones(nq, dtype=torch.bool, device=q.device)
    else:
        exact = top_d2[:, -1] <= mind_sel[:, n_c]
    return rows[cand].reshape(nq, n_c * s).gather(1, topi), top_d2, exact
