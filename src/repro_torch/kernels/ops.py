"""Public wrappers over the Hopper kernels, under the JAX package's names.

The device of the tensors picks the path: a CPU tensor goes to the plain
version in ``ref.py``, a CUDA tensor to the CUDA kernel, which launches or
raises.  There is no fallback from one to the other, and any other device
raises.  All tensors of one call lie on one device.
"""
from __future__ import annotations

import torch

from . import knn_topk as _knn
from . import partition_assign as _pa
from . import ref
from . import window_filter as _wf

# ceiling on how many distance-matrix elements one ``knn_topk`` step may
# materialise (f32: 64 MiB); larger batches stream in query chunks
KNN_MAX_ELEMS = 16 * 1024 * 1024


def _route(t: torch.Tensor) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(
            f"no kernel for device {t.device}: pass CPU or CUDA tensors"
        )
    return kind


def box_hits_tiled(lo, hi, qlo, qhi):
    """(n, nq) int32 box-intersection mask; ``lo``/``hi`` f32 or bf16."""
    if _route(lo) == "cpu":
        return ref.box_hits_tiled_ref(lo, hi, qlo, qhi)
    return _wf.box_hits(lo, hi, qlo, qhi)


def pair_window_ids(qlo, qhi, leaf_lo, leaf_hi, leaf_pts, leaf_ids,
                    leaf_counts, q_idx, leaf_idx, pair_valid):
    """Fused (window, leaf) pair scan: ``(ids_or (P, S), counts (P,))``."""
    args = (qlo, qhi, leaf_lo, leaf_hi, leaf_pts, leaf_ids, leaf_counts,
            q_idx, leaf_idx, pair_valid)
    if _route(qlo) == "cpu":
        return ref.pair_window_ids_ref(*args)
    return _wf.pair_window_ids(*args)


def leaf_mindist_tiled(queries, leaf_lo, leaf_hi):
    """(nq, L) squared box mindists; ``leaf_lo``/``leaf_hi`` f32 or bf16."""
    if _route(queries) == "cpu":
        return ref.leaf_mindist_ref(queries, leaf_lo, leaf_hi)
    return _knn.leaf_mindist(queries, leaf_lo, leaf_hi)


def pair_dist2(queries, leaf_pts, leaf_counts, q_idx, leaf_idx):
    """Fused (query, leaf) candidate distances: (P, S), invalid = f32 max."""
    if _route(queries) == "cpu":
        return ref.pair_dist2_ref(queries, leaf_pts, leaf_counts, q_idx, leaf_idx)
    return _knn.pair_dist2(queries, leaf_pts, leaf_counts, q_idx, leaf_idx)


def partition_assign(points, split_dim, split_val, *, levels: int):
    """(n,) int32 leaf id per point through heap-form split tables."""
    if _route(points) == "cpu":
        return ref.partition_assign_ref(points, split_dim, split_val, levels=levels)
    return _pa.partition_assign(points, split_dim, split_val, levels=levels)


def pairwise_dist2(queries, points, valid=None):
    """Masked (nq, np) squared distances; ``valid`` defaults to all ones."""
    if valid is None:
        valid = torch.ones(points.shape[0], dtype=torch.int32, device=points.device)
    if _route(queries) == "cpu":
        return ref.pairwise_dist2_ref(queries, points, valid)
    return _knn.pairwise_dist2(queries, points, valid)


def knn_topk(queries, points, k: int, valid=None):
    """k nearest points per query: distance rows from ``pairwise_dist2``
    and a ``smallest_k`` selection (lower index first among equal
    distances, NaN last).

    Returns ``(indices (nq, k), dists_sq (nq, k))``.  When the (nq, np)
    distance matrix would exceed ``KNN_MAX_ELEMS`` elements, the queries
    run in chunks sized to the cap, so one chunk's distances are live at
    a time."""
    chunk = max(KNN_MAX_ELEMS // max(points.shape[0], 1), 1)
    parts = [ref.smallest_k(pairwise_dist2(queries[s:s + chunk], points, valid), k)
             for s in range(0, max(queries.shape[0], 1), chunk)]
    return torch.cat([i for _, i in parts]), torch.cat([v for v, _ in parts])


def window_count_gathered(lo, hi, points, valid):
    """(nq,) int32 in-window counts over per-query gathered (nq, npp, d)
    points with their own validity mask."""
    if _route(lo) == "cpu":
        return ref.window_count_gathered_ref(lo, hi, points, valid)
    return _wf.window_count_gathered(lo, hi, points, valid)


def gathered_dist2(queries, points, valid):
    """Per-query gathered squared distances (nq, npp), invalid = f32 max."""
    if _route(queries) == "cpu":
        return ref.gathered_dist2_ref(queries, points, valid)
    return _knn.gathered_dist2(queries, points, valid)


def window_mask_gathered(lo, hi, points, valid):
    """(nq, npp) int32 containment mask over per-query gathered (nq, npp, d)
    points with their own validity mask."""
    if _route(lo) == "cpu":
        return ref.window_mask_gathered_ref(lo, hi, points, valid)
    return _wf.window_mask_gathered(lo, hi, points, valid)


def window_count(lo, hi, points, valid=None):
    """(nq,) int32 in-window counts over one shared (np, d) point table;
    ``valid`` defaults to every point."""
    if _route(lo) == "cpu":
        return ref.window_count_ref(lo, hi, points, valid)
    return _wf.window_count_tiles(lo, hi, points, valid)
