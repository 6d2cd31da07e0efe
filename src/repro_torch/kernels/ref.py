"""Plain PyTorch versions of the four Hopper kernels (the correctness
contracts).

Same names and argument order as the JAX package's ``kernels/ref.py``.
Each function runs on whatever device its tensors lie on: the CPU tests
use it as the engine's arithmetic, and ``chip_smoke.py`` holds each CUDA
kernel against it on the card.  Sums run per dimension, in the kernels'
order, as separate elementwise operations: eager PyTorch never contracts
``a + b * c`` into a fused multiply-add, and the kernels round each
operation on its own (``__fsub_rn``/``__fmul_rn``/``__fadd_rn``), so the
two agree bit for bit.
"""
from __future__ import annotations

import torch

F32_MAX = torch.finfo(torch.float32).max


def box_hits_tiled_ref(lo, hi, qlo, qhi):
    """(n, nq) int32 box-intersection mask ``lo <= qhi & hi >= qlo`` over
    every dimension; bf16 bounds are widened to f32 first (exact)."""
    lo = lo.float()
    hi = hi.float()
    acc = None
    for k in range(lo.shape[1]):
        h = (lo[:, k, None] <= qhi[None, :, k]) & (hi[:, k, None] >= qlo[None, :, k])
        acc = h if acc is None else acc & h
    return acc.to(torch.int32)


def pair_window_ids_ref(qlo, qhi, leaf_lo, leaf_hi, leaf_pts, leaf_ids,
                        leaf_counts, q_idx, leaf_idx, pair_valid):
    """Per (query, leaf) pair: exact f32 leaf-box re-check, slot validity
    and point containment.  Returns ``(ids_or (P, S) int32, counts (P,)
    int32)``: the slot's dataset row where the point lies in the pair's
    window, else -1."""
    q_idx = q_idx.long()
    leaf_idx = leaf_idx.long()
    lo_p = qlo[q_idx]                          # (P, d)
    hi_p = qhi[q_idx]
    pts = leaf_pts[leaf_idx]                   # (P, S, d)
    ids = leaf_ids[leaf_idx]                   # (P, S)
    s = leaf_pts.shape[1]
    slot = torch.arange(s, dtype=torch.int32, device=leaf_pts.device)
    valid = (slot[None, :] < leaf_counts[leaf_idx][:, None]) & (
        pair_valid[:, None] > 0
    )
    box_ok = torch.all(
        (leaf_lo[leaf_idx].float() <= hi_p) & (leaf_hi[leaf_idx].float() >= lo_p),
        dim=1,
    )
    inside = (
        torch.all((pts >= lo_p[:, None, :]) & (pts <= hi_p[:, None, :]), dim=2)
        & valid
        & box_ok[:, None]
    )
    counts = inside.sum(dim=1, dtype=torch.int32)
    return torch.where(inside, ids, torch.full_like(ids, -1)), counts


def leaf_mindist_ref(queries, leaf_lo, leaf_hi):
    """(nq, L) squared box mindists ``sum_d (max(lo-q,0) + max(q-hi,0))^2``,
    accumulated per dimension in the kernel's order."""
    lo = leaf_lo.float()
    hi = leaf_hi.float()
    acc = torch.zeros(queries.shape[0], lo.shape[0], dtype=torch.float32,
                      device=queries.device)
    for k in range(queries.shape[1]):
        qk = queries[:, k, None]
        g = torch.clamp_min(lo[None, :, k] - qk, 0.0) + torch.clamp_min(
            qk - hi[None, :, k], 0.0
        )
        acc = acc + g * g
    return acc


def pair_dist2_ref(queries, leaf_pts, leaf_counts, q_idx, leaf_idx):
    """(P, S) squared distances from each pair's query to each slot of its
    leaf, accumulated per dimension; slots at or past the leaf's count
    carry f32 max (so they sort last)."""
    q_idx = q_idx.long()
    leaf_idx = leaf_idx.long()
    q = queries[q_idx]                         # (P, d)
    pts = leaf_pts[leaf_idx]                   # (P, S, d)
    s = leaf_pts.shape[1]
    acc = torch.zeros(pts.shape[:2], dtype=torch.float32, device=pts.device)
    for k in range(pts.shape[2]):
        diff = pts[:, :, k] - q[:, k, None]
        acc = acc + diff * diff
    slot = torch.arange(s, dtype=torch.int32, device=pts.device)
    valid = slot[None, :] < leaf_counts[leaf_idx][:, None]
    return torch.where(valid, acc, torch.full_like(acc, F32_MAX))
