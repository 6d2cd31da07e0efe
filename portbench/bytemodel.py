"""The frozen byte model behind the kernels' roofline shares.

Each count is of the bytes that the work of one request needs, from the
request's queries and the index's live sizes: every input byte once and
every output byte once, as float32 coordinates and distances, 4-byte ids
and one byte per box test.  Nothing here depends on how the program
launches its kernels (chunks, padded slots, power-of-two buckets, the
dtype of its intermediates), so a change to the program leaves the counts
as they are.

* ``box_hits``: every node box and every window read, one test result
  per (node, window) written.
* ``pair_window_ids``: the windows, and each leaf that some window truly
  intersects read once (its live points and ids, and its box); the ids
  returned written.
* ``leaf_mindist``: the queries and every leaf box read, one distance per
  (query, leaf) written.
* ``pair_dist2``: the queries, and each leaf that the exact answer needs
  read once (its live points): a leaf whose box lies within the k-th
  neighbour's distance of some query; one distance per live point of
  each such (query, leaf) pair written.
"""
from __future__ import annotations

import torch

F32 = 4
ID = 4
TEST = 1


def box_hits(n_nodes: int, d: int, q: int) -> int:
    return n_nodes * 2 * d * F32 + q * 2 * d * F32 + n_nodes * q * TEST


def intersecting(leaf_lo, leaf_hi, los, his) -> torch.Tensor:
    """(Q, L) bool: window ``i``'s closed box meets leaf ``j``'s."""
    hit = torch.ones((los.shape[0], leaf_lo.shape[0]), dtype=torch.bool,
                     device=leaf_lo.device)
    for k in range(leaf_lo.shape[1]):
        hit &= (los[:, k, None] <= leaf_hi[None, :, k]) & (his[:, k, None] >= leaf_lo[None, :, k])
    return hit


def pair_window_ids(hit: torch.Tensor, counts: torch.Tensor, d: int, ids_returned: int) -> int:
    used = hit.any(dim=0)
    leaves = int(used.sum())
    slots = int(counts[used].sum())
    return hit.shape[0] * 2 * d * F32 + slots * (d * F32 + ID) + leaves * 2 * d * F32 \
        + ids_returned * ID


def leaf_mindist(n_leaves: int, d: int, q: int) -> int:
    return q * d * F32 + n_leaves * 2 * d * F32 + q * n_leaves * F32


def mindist2(leaf_lo, leaf_hi, qs) -> torch.Tensor:
    """(Q, L) float64 squared distance from each query to each leaf box."""
    lo, hi, q = leaf_lo.double(), leaf_hi.double(), qs.double()
    acc = torch.zeros((q.shape[0], lo.shape[0]), dtype=torch.float64, device=q.device)
    for k in range(lo.shape[1]):
        gap = torch.clamp(lo[None, :, k] - q[:, k, None], min=0) \
            + torch.clamp(q[:, k, None] - hi[None, :, k], min=0)
        acc += gap * gap
    return acc


def pair_dist2(need: torch.Tensor, counts: torch.Tensor, d: int) -> int:
    used = need.any(dim=0)
    per_pair = int((need.double() @ counts.double()).sum())
    return need.shape[0] * d * F32 + int(counts[used].sum()) * d * F32 + per_pair * F32
