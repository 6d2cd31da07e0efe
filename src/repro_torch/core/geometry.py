"""Shared box geometry: intersection and mindist helpers.

Every traversal layer needs the same three predicates — box-vs-box
intersection, point-to-box mindist, box-to-box mindist — and they had
drifted into per-file copies (``queries.py``, ``ambi.py``,
``distributed.py``).  This module is the single home for the scalar forms
plus the batched forms the sharded query router uses (one (Q, m) plane per
predicate, no Python loop).

Conventions: a box is either an ``(2, d)`` stacked ``[lo; hi]`` array
(the ``mbb`` layout construction code carries) or a separate ``lo``/``hi``
pair; batched variants take ``(m, d)`` column pairs.  All tests are
closed-interval, matching the paper's window semantics.
"""
from __future__ import annotations

import numpy as np


# --------------------------------------------------------------------------
# scalar forms (one box, one query)
# --------------------------------------------------------------------------
def mbb_intersects(mbb: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> bool:
    """Does box ``mbb`` ((2, d) [lo; hi]) intersect the window [lo, hi]?"""
    return bool(np.all(mbb[0] <= hi) and np.all(mbb[1] >= lo))


def mindist_sq(mbb: np.ndarray, q: np.ndarray) -> float:
    """Squared min distance from point ``q`` to box ``mbb`` (0 if inside)."""
    d = np.maximum(mbb[0] - q, 0.0) + np.maximum(q - mbb[1], 0.0)
    return float(np.dot(d, d))


def mindist_box_sq(mbb: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> float:
    """Squared min distance between box ``mbb`` and box [lo, hi] (0 when
    they intersect)."""
    gap = np.maximum(mbb[0] - hi, 0.0) + np.maximum(lo - mbb[1], 0.0)
    return float(np.dot(gap, gap))


# --------------------------------------------------------------------------
# batched forms (m boxes x Q queries): the sharded router's primitives
# --------------------------------------------------------------------------
def boxes_intersect_windows(
    box_lo: np.ndarray, box_hi: np.ndarray, los: np.ndarray, his: np.ndarray
) -> np.ndarray:
    """(Q, m) mask: does box ``j`` intersect window ``i``?"""
    return np.all(box_lo[None, :, :] <= his[:, None, :], axis=2) & np.all(
        box_hi[None, :, :] >= los[:, None, :], axis=2
    )


def boxes_mindist_sq(
    box_lo: np.ndarray, box_hi: np.ndarray, qs: np.ndarray
) -> np.ndarray:
    """(Q, m) squared min distances from query points to boxes."""
    gap = np.maximum(box_lo[None, :, :] - qs[:, None, :], 0.0) + np.maximum(
        qs[:, None, :] - box_hi[None, :, :], 0.0
    )
    return np.einsum("qmd,qmd->qm", gap, gap)
