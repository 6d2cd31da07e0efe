"""d-dimensional Hilbert curve ranks (for the Hilbert-packing baseline).

Vectorized iterative transpose algorithm (Skilling, AIP 2004): converts
integer grid coordinates to the Hilbert index, for arbitrary dimensionality.
``bits`` per dimension is capped so the interleaved rank fits in uint64,
which keeps everything fully vectorized.
"""
from __future__ import annotations

import numpy as np


def hilbert_rank(points: np.ndarray, bits: int | None = None) -> np.ndarray:
    """Hilbert indices for float points (any bounding box) as uint64.

    Points are normalized to the [0, 2^bits) integer grid per dimension;
    ``bits`` defaults to the largest precision with d*bits <= 63.
    """
    pts = np.asarray(points, dtype=np.float64)
    n, d = pts.shape
    if bits is None:
        bits = 63 // d
    bits = min(bits, 63 // d)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    grid = ((pts - lo) / span * (2**bits - 1)).astype(np.uint64)
    x = grid.T.copy()  # (d, n)
    one = np.uint64(1)

    m = one << np.uint64(bits - 1)
    # Inverse undo excess work (Skilling transform)
    q = m
    while q > one:
        p = q - one
        for i in range(d):
            hit = (x[i] & q) != 0
            x[0][hit] ^= p  # invert
            t = (x[0] ^ x[i]) & p  # exchange
            x[0][~hit] ^= t[~hit]
            x[i][~hit] ^= t[~hit]
        q >>= one
    # Gray encode
    for i in range(1, d):
        x[i] ^= x[i - 1]
    t = np.zeros(n, dtype=np.uint64)
    q = m
    while q > one:
        mask = (x[d - 1] & q) != 0
        t[mask] ^= q - one
        q >>= one
    for i in range(d):
        x[i] ^= t

    # interleave bits (MSB of dim 0 first)
    ranks = np.zeros(n, dtype=np.uint64)
    for b in range(bits - 1, -1, -1):
        for i in range(d):
            ranks = (ranks << one) | ((x[i] >> np.uint64(b)) & one)
    return ranks


def hilbert_sort(points: np.ndarray, bits: int | None = None) -> np.ndarray:
    """Row order that sorts ``points`` along the Hilbert curve."""
    return np.argsort(hilbert_rank(points, bits=bits), kind="stable")
