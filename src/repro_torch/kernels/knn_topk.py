"""Launchers for ``csrc/knn_topk.cu``: ``leaf_mindist``, ``pair_dist2``,
``pairwise_dist2`` and ``gathered_dist2`` on CUDA tensors.

They replace the JAX package's Pallas kernels of the same names
(``leaf_mindist_tiled`` for the first; ``repro/kernels/knn_topk.py``).  Each launcher checks its
arguments, allocates the output with ``torch.empty``, launches on the
current stream without synchronising, raises on a launch error and bumps
its launch count.
"""
from __future__ import annotations

import functools

import torch

from . import build, launches

_F32 = (torch.float32,)
_BOUNDS = (torch.float32, torch.bfloat16)
_I32 = (torch.int32,)


@functools.cache
def _fn(symbol: str, n_ptrs: int, n_ints: int):
    return build.bind(build.library("knn_topk"), symbol, n_ptrs, n_ints)


def leaf_mindist(queries, leaf_lo, leaf_hi) -> torch.Tensor:
    """(nq, L) f32 squared mindists from each query to each leaf box."""
    nq, d = queries.shape
    n_l = leaf_lo.shape[0]
    launches.check_dim(d)
    launches.check(queries, "queries", _F32, (nq, d))
    launches.check(leaf_lo, "leaf_lo", _BOUNDS, (n_l, d))
    launches.check(leaf_hi, "leaf_hi", (leaf_lo.dtype,), (n_l, d))
    launches.same_device(queries, leaf_lo, leaf_hi)
    if -(-nq // 16) > 65535:
        raise ValueError(f"leaf_mindist takes at most {65535 * 16} queries, got {nq}")
    launches.check_extents(L=n_l)
    out = torch.empty((nq, n_l), dtype=torch.float32, device=queries.device)
    if out.numel() == 0:  # nothing to launch
        return out
    rc = _fn("leaf_mindist_launch", 4, 4)(
        queries.data_ptr(), leaf_lo.data_ptr(), leaf_hi.data_ptr(),
        out.data_ptr(), int(leaf_lo.dtype == torch.bfloat16), nq, n_l, d,
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    launches.raise_on_error(rc, "leaf_mindist")
    launches.bump("leaf_mindist")
    return out


def pair_dist2(queries, leaf_pts, leaf_counts, q_idx, leaf_idx) -> torch.Tensor:
    """(P, S) f32 squared distances per (query, leaf) pair; slots at or
    past the leaf's count carry f32 max."""
    nq, d = queries.shape
    n_l, s, _ = leaf_pts.shape
    p = q_idx.shape[0]
    launches.check_dim(d)
    launches.check(queries, "queries", _F32, (nq, d))
    launches.check(leaf_pts, "leaf_pts", _F32, (n_l, s, d))
    launches.check(leaf_counts, "leaf_counts", _I32, (n_l,))
    launches.check(q_idx, "q_idx", _I32, (p,))
    launches.check(leaf_idx, "leaf_idx", _I32, (p,))
    launches.same_device(queries, leaf_pts, leaf_counts, q_idx, leaf_idx)
    launches.check_extents(P=p, nq=nq, L=n_l)
    out = torch.empty((p, s), dtype=torch.float32, device=queries.device)
    if out.numel() == 0:  # nothing to launch
        return out
    rc = _fn("pair_dist2_launch", 6, 5)(
        queries.data_ptr(), leaf_pts.data_ptr(), leaf_counts.data_ptr(),
        q_idx.data_ptr(), leaf_idx.data_ptr(), out.data_ptr(), p, nq, n_l, s, d,
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    launches.raise_on_error(rc, "pair_dist2")
    launches.bump("pair_dist2")
    return out


_PD_QT = 8            # queries per block of pairwise_dist2 (gridDim.y)
_GD_THREADS = 256     # threads per block of gathered_dist2


def pairwise_dist2(queries, points, valid) -> torch.Tensor:
    """(nq, np) f32 squared distances ``sum_d (q - p)^2``; points with
    ``valid <= 0`` carry f32 max."""
    nq, d = queries.shape
    n_p = points.shape[0]
    launches.check_dim(d)
    launches.check(queries, "queries", _F32, (nq, d))
    launches.check(points, "points", _F32, (n_p, d))
    launches.check(valid, "valid", _I32, (n_p,))
    launches.same_device(queries, points, valid)
    if -(-nq // _PD_QT) > 65535:
        raise ValueError(f"pairwise_dist2 takes at most {65535 * _PD_QT} queries, got {nq}")
    launches.check_extents(np=n_p)
    out = torch.empty((nq, n_p), dtype=torch.float32, device=queries.device)
    if out.numel() == 0:  # nothing to launch
        return out
    rc = _fn("pairwise_dist2_launch", 4, 3)(
        queries.data_ptr(), points.data_ptr(), valid.data_ptr(), out.data_ptr(),
        nq, n_p, d, torch.cuda.current_stream(queries.device).cuda_stream,
    )
    launches.raise_on_error(rc, "pairwise_dist2")
    launches.bump("pairwise_dist2")
    return out


def gathered_dist2(queries, points, valid) -> torch.Tensor:
    """(nq, npp) f32 squared distances ``sum_d (p - q)^2`` from each query
    to its own gathered points; slots with ``valid <= 0`` carry f32 max."""
    nq, npp, d = points.shape
    launches.check_dim(d)
    launches.check(queries, "queries", _F32, (nq, d))
    launches.check(points, "points", _F32, (nq, npp, d))
    launches.check(valid, "valid", _I32, (nq, npp))
    launches.same_device(queries, points, valid)
    launches.check_extents(nq=nq, npp=npp, blocks=-(-nq * npp // _GD_THREADS))
    out = torch.empty((nq, npp), dtype=torch.float32, device=queries.device)
    if out.numel() == 0:  # nothing to launch
        return out
    rc = _fn("gathered_dist2_launch", 4, 3)(
        queries.data_ptr(), points.data_ptr(), valid.data_ptr(), out.data_ptr(),
        nq, npp, d, torch.cuda.current_stream(queries.device).cuda_stream,
    )
    launches.raise_on_error(rc, "gathered_dist2")
    launches.bump("gathered_dist2")
    return out
