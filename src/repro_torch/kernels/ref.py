"""Plain PyTorch versions of the Hopper kernels (the correctness
contracts), and the ``top_k``/``smallest_k`` selections that the port
runs beside them.

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


_BITS = {torch.float64: torch.int64, torch.float32: torch.int32,
         torch.float16: torch.int16, torch.bfloat16: torch.int16}


def total_order_key(x):
    """Integer keys that rank floats as ``jax.lax.top_k`` does, by the
    float total order: -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN.
    The bit pattern with its magnitude bits flipped where the sign is
    set; integer inputs are their own keys."""
    if not x.is_floating_point():
        return x
    bits = x.view(_BITS[x.dtype])
    return bits ^ ((bits >> (bits.element_size() * 8 - 1)) & torch.iinfo(bits.dtype).max)


def top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values in
    descending order of the float total order (``total_order_key``), the
    lower index first among equal keys (a stable sort; ``torch.topk``
    leaves the order of ties unspecified, and ``torch.sort`` puts every
    NaN first whatever its sign)."""
    _, idx = torch.sort(total_order_key(x), dim=-1, descending=True, stable=True)
    idx = idx[..., :k]
    return x.gather(-1, idx), idx


def smallest_k(x, k: int):
    """``top_k(-x, k)`` without the negation: the ``k`` smallest values in
    ascending total order (a NaN of positive sign last), the lower index
    first among equal keys.  Returns ``(values, indices)``.  The k-NN
    selections use it: on the card a negation does not keep a NaN's sign
    (the device's arithmetic returns its canonical, positive NaN), so
    ``top_k(-d2)`` would rank a NaN distance first there."""
    _, idx = torch.sort(total_order_key(x), dim=-1, stable=True)
    idx = idx[..., :k]
    return x.gather(-1, idx), idx


def partition_assign_ref(points, split_dim, split_val, *, levels: int):
    """Leaf id per point through heap-form split tables ``[level, group]``:
    ``g = 2 g + (coord > val)`` per level, plain gathers.  Non-finite split
    values read as f32 max (the kernel's sanitising, which changes only
    entries a built index never selects), and split dimensions are clamped
    to ``[0, d)`` as a JAX gather clamps its index."""
    n, d = points.shape
    g = torch.zeros(n, dtype=torch.int32, device=points.device)
    rows = torch.arange(n, device=points.device)
    val_t = torch.where(torch.isfinite(split_val), split_val,
                        torch.full_like(split_val, F32_MAX))
    for level in range(levels):
        gl = g.long()
        dim = split_dim[level, gl].long().clamp(0, d - 1)
        coord = points[rows, dim]
        g = g * 2 + (coord > val_t[level, gl]).to(torch.int32)
    return g


def pairwise_dist2_ref(queries, points, valid):
    """(nq, np) squared distances ``sum_d (q - p)^2`` by direct subtraction,
    accumulated per dimension; points with ``valid <= 0`` carry f32 max."""
    acc = torch.zeros(queries.shape[0], points.shape[0], dtype=torch.float32,
                      device=points.device)
    for k in range(points.shape[1]):
        diff = queries[:, k, None] - points[None, :, k]
        acc = acc + diff * diff
    return torch.where(valid[None, :] > 0, acc, torch.full_like(acc, F32_MAX))


def knn_topk_ref(queries, points, valid, k: int):
    """k nearest points per query: the full distance matrix and a top-k
    (lower index first among equal distances).  Returns ``(idx, dists)``."""
    d2, idx = smallest_k(pairwise_dist2_ref(queries, points, valid), k)
    return idx, d2


def window_count_gathered_ref(lo, hi, points, valid):
    """(nq,) int32 in-window counts, each query over its own gathered
    ``(npp, d)`` points, slots with ``valid <= 0`` excluded."""
    inside = valid > 0
    for k in range(points.shape[2]):
        pk = points[:, :, k]
        inside = inside & (pk >= lo[:, k, None]) & (pk <= hi[:, k, None])
    return inside.sum(dim=1, dtype=torch.int32)


def window_mask_gathered_ref(lo, hi, points, valid):
    """(nq, npp) int32 mask: 1 where the slot is valid (``valid > 0``) and
    its point lies in its query's window (``p >= lo & p <= hi`` in every
    dimension, so a NaN coordinate is never inside)."""
    inside = valid > 0
    for k in range(points.shape[2]):
        pk = points[:, :, k]
        inside = inside & (pk >= lo[:, k, None]) & (pk <= hi[:, k, None])
    return inside.to(torch.int32)


# ceiling on the bytes of one (nq, chunk) plane of ``window_count_ref``
WINDOW_COUNT_PLANE_BYTES = 256 * 1024 * 1024


def window_count_ref(lo, hi, points, valid=None):
    """(nq,) int32 in-window counts over one shared ``(np, d)`` point
    table; points with ``valid <= 0`` excluded (``valid=None``: every
    point counts).  The point axis runs in chunks so that one (nq, chunk)
    plane stays within ``WINDOW_COUNT_PLANE_BYTES``; integer sums are
    exact in any order."""
    nq, n_p = lo.shape[0], points.shape[0]
    out = torch.zeros(nq, dtype=torch.int32, device=lo.device)
    chunk = max(WINDOW_COUNT_PLANE_BYTES // max(nq, 1), 1)
    for s in range(0, n_p, chunk):
        p = points[s:s + chunk]
        if valid is None:
            inside = torch.ones((1, p.shape[0]), dtype=torch.bool, device=p.device)
        else:
            inside = valid[None, s:s + chunk] > 0
        for k in range(p.shape[1]):
            pk = p[None, :, k]
            inside = inside & (pk >= lo[:, k, None]) & (pk <= hi[:, k, None])
        out += inside.sum(dim=1, dtype=torch.int32)
    return out


def gathered_dist2_ref(queries, points, valid):
    """(nq, npp) squared distances ``sum_d (p - q)^2`` from each query to
    its own gathered points, accumulated per dimension; slots with
    ``valid <= 0`` carry f32 max."""
    acc = torch.zeros(points.shape[:2], dtype=torch.float32, device=points.device)
    for k in range(points.shape[2]):
        diff = points[:, :, k] - queries[:, k, None]
        acc = acc + diff * diff
    return torch.where(valid > 0, acc, torch.full_like(acc, F32_MAX))
