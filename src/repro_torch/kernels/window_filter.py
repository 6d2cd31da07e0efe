"""Launchers for ``csrc/window_filter.cu``: ``box_hits``,
``pair_window_ids`` and ``window_count_gathered`` on CUDA tensors.

They replace the JAX package's Pallas kernels of the same names
(``box_hits_tiled`` for the first; ``repro/kernels/window_filter.py``).  Each launcher
checks its arguments, allocates the outputs with ``torch.empty``, launches
on the current stream without synchronising, raises on a launch error and
bumps its launch count.
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
    return build.bind(build.library("window_filter"), symbol, n_ptrs, n_ints)


def box_hits(lo, hi, qlo, qhi) -> torch.Tensor:
    """(n, nq) int32: 1 where box ``i`` intersects window ``j``."""
    n, d = lo.shape
    nq = qlo.shape[0]
    launches.check_dim(d)
    launches.check(lo, "lo", _BOUNDS, (n, d))
    launches.check(hi, "hi", (lo.dtype,), (n, d))
    launches.check(qlo, "qlo", _F32, (nq, d))
    launches.check(qhi, "qhi", _F32, (nq, d))
    launches.same_device(lo, hi, qlo, qhi)
    if -(-nq // 32) > 65535:
        raise ValueError(f"box_hits takes at most {65535 * 32} windows, got {nq}")
    launches.check_extents(n=n)
    out = torch.empty((n, nq), dtype=torch.int32, device=lo.device)
    if out.numel() == 0:  # nothing to launch
        return out
    rc = _fn("box_hits_launch", 5, 4)(
        lo.data_ptr(), hi.data_ptr(), qlo.data_ptr(), qhi.data_ptr(),
        out.data_ptr(), int(lo.dtype == torch.bfloat16), n, nq, d,
        torch.cuda.current_stream(lo.device).cuda_stream,
    )
    launches.raise_on_error(rc, "box_hits")
    launches.bump("box_hits")
    return out


def pair_window_ids(qlo, qhi, leaf_lo, leaf_hi, leaf_pts, leaf_ids,
                    leaf_counts, q_idx, leaf_idx, pair_valid):
    """``(ids_or (P, S) int32, counts (P,) int32)`` for (window, leaf)
    pairs; see ``ref.pair_window_ids_ref`` for the contract."""
    nq, d = qlo.shape
    n_l, s, _ = leaf_pts.shape
    p = q_idx.shape[0]
    launches.check_dim(d)
    launches.check(qlo, "qlo", _F32, (nq, d))
    launches.check(qhi, "qhi", _F32, (nq, d))
    launches.check(leaf_lo, "leaf_lo", _F32, (n_l, d))
    launches.check(leaf_hi, "leaf_hi", _F32, (n_l, d))
    launches.check(leaf_pts, "leaf_pts", _F32, (n_l, s, d))
    launches.check(leaf_ids, "leaf_ids", _I32, (n_l, s))
    launches.check(leaf_counts, "leaf_counts", _I32, (n_l,))
    launches.check(q_idx, "q_idx", _I32, (p,))
    launches.check(leaf_idx, "leaf_idx", _I32, (p,))
    launches.check(pair_valid, "pair_valid", _I32, (p,))
    launches.same_device(qlo, qhi, leaf_lo, leaf_hi, leaf_pts, leaf_ids,
                         leaf_counts, q_idx, leaf_idx, pair_valid)
    launches.check_extents(P=p, nq=nq, L=n_l)
    ids_or = torch.empty((p, s), dtype=torch.int32, device=qlo.device)
    counts = torch.empty((p,), dtype=torch.int32, device=qlo.device)
    if ids_or.numel() == 0:  # nothing to launch
        return ids_or, counts
    rc = _fn("pair_window_ids_launch", 12, 5)(
        qlo.data_ptr(), qhi.data_ptr(), leaf_lo.data_ptr(), leaf_hi.data_ptr(),
        leaf_pts.data_ptr(), leaf_ids.data_ptr(), leaf_counts.data_ptr(),
        q_idx.data_ptr(), leaf_idx.data_ptr(), pair_valid.data_ptr(),
        ids_or.data_ptr(), counts.data_ptr(), p, nq, n_l, s, d,
        torch.cuda.current_stream(qlo.device).cuda_stream,
    )
    launches.raise_on_error(rc, "pair_window_ids")
    launches.bump("pair_window_ids")
    return ids_or, counts


def window_count_gathered(lo, hi, points, valid) -> torch.Tensor:
    """(nq,) int32 in-window counts, each window over its own gathered
    ``(npp, d)`` points; see ``ref.window_count_gathered_ref``."""
    nq, npp, d = points.shape
    launches.check_dim(d)
    launches.check(lo, "lo", _F32, (nq, d))
    launches.check(hi, "hi", _F32, (nq, d))
    launches.check(points, "points", _F32, (nq, npp, d))
    launches.check(valid, "valid", _I32, (nq, npp))
    launches.same_device(lo, hi, points, valid)
    launches.check_extents(nq=nq, npp=npp)
    out = torch.empty((nq,), dtype=torch.int32, device=lo.device)
    if nq == 0:  # nothing to launch
        return out
    rc = _fn("window_count_gathered_launch", 5, 3)(
        lo.data_ptr(), hi.data_ptr(), points.data_ptr(), valid.data_ptr(),
        out.data_ptr(), nq, npp, d,
        torch.cuda.current_stream(lo.device).cuda_stream,
    )
    launches.raise_on_error(rc, "window_count_gathered")
    launches.bump("window_count_gathered")
    return out
