"""Public wrappers over the Hopper kernels, under the JAX package's names.

The device of the tensors picks the path: a CPU tensor goes to the plain
version in ``ref.py``, a CUDA tensor to the CUDA kernel, which launches or
raises.  There is no fallback from one to the other, and any other device
raises.  All tensors of one call lie on one device.
"""
from __future__ import annotations

import torch

from . import knn_topk as _knn
from . import ref
from . import window_filter as _wf


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
