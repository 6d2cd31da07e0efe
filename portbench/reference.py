"""The plain reference: brute-force windows and k nearest neighbours.

Plain PyTorch over the benchmark's own points, in blocks of queries so
that it fits beside nothing else on the card.  It imports nothing of the
program and takes nothing the program made.  ``dtype`` is the arithmetic:
float64 is the reference; bfloat16, the precision below the configured
float32, is the control that the comparison must catch.
"""
from __future__ import annotations

import numpy as np
import torch

# elements of one (queries, points) block: bounds the reference's memory
BLOCK_ELEMS = 1 << 27


def _rows(n_points: int) -> int:
    return max(1, BLOCK_ELEMS // max(n_points, 1))


def window_ids(points: torch.Tensor, los: np.ndarray, his: np.ndarray,
               dtype=torch.float64) -> list[np.ndarray]:
    """Sorted ids of the points inside each closed box ``[lo, hi]``."""
    pts = points.to(dtype)
    lo = torch.from_numpy(np.asarray(los)).to(points.device, dtype)
    hi = torch.from_numpy(np.asarray(his)).to(points.device, dtype)
    out = []
    step = _rows(pts.shape[0])
    for a in range(0, lo.shape[0], step):
        inside = torch.ones((min(step, lo.shape[0] - a), pts.shape[0]),
                            dtype=torch.bool, device=pts.device)
        for k in range(pts.shape[1]):
            col = pts[:, k][None, :]
            inside &= (col >= lo[a:a + step, k, None]) & (col <= hi[a:a + step, k, None])
        for row in inside:
            out.append(torch.nonzero(row).flatten().cpu().numpy())
    return out


def sq_dists(points: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """(Q, n) squared distances, summed per dimension in ``qs``'s dtype."""
    acc = torch.zeros((qs.shape[0], points.shape[0]), dtype=qs.dtype,
                      device=points.device)
    for k in range(points.shape[1]):
        diff = points[:, k][None, :] - qs[:, k, None]
        acc += diff * diff
    return acc


def knn_ids(points: torch.Tensor, qs: np.ndarray, k: int,
            dtype=torch.float64) -> list[np.ndarray]:
    """Ids of the ``k`` points nearest each query, nearest first (ties in
    any order)."""
    pts = points.to(dtype)
    q = torch.from_numpy(np.asarray(qs)).to(points.device, dtype)
    out = []
    step = _rows(pts.shape[0])
    for a in range(0, q.shape[0], step):
        d2 = sq_dists(pts, q[a:a + step])
        idx = torch.topk(d2, min(k, pts.shape[0]), dim=1, largest=False).indices
        out.extend(idx.cpu().numpy())
    return out


def knn_dists(points: torch.Tensor, qs: np.ndarray, ids: list) -> list[np.ndarray]:
    """Float64 squared distances of the given ids from each query, sorted
    ascending; ids outside the points give +inf."""
    pts = points.to(torch.float64)
    out = []
    for q, row in zip(np.asarray(qs, dtype=np.float64), ids):
        row = np.asarray(row, dtype=np.int64)
        ok = (row >= 0) & (row < pts.shape[0])
        d2 = np.full(len(row), np.inf)
        if ok.any():
            sel = pts[torch.from_numpy(row[ok]).to(pts.device)]
            qt = torch.from_numpy(q).to(pts.device)
            d2[ok] = ((sel - qt) ** 2).sum(dim=1).cpu().numpy()
        out.append(np.sort(d2))
    return out
