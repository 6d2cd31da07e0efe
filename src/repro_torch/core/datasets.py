"""Dataset generators mirroring the paper's evaluation data.

OSM and NYCYT are not redistributable offline; these generators reproduce
their documented *shape*: OSM-like data is a world-map mixture of dense urban
clusters plus vast empty regions (oceans), NYCYT-like data is 5-D correlated
trip records (pickup x/y, dropoff x/y, time).  Uniform / gaussian / skewed
match the paper's repository extras.
"""
from __future__ import annotations

import numpy as np


def uniform(n: int, d: int = 2, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.random((n, d)).astype(np.float64)


def gaussian(n: int, d: int = 2, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.5, 0.12, size=(n, d))
    return np.clip(pts, 0.0, 1.0).astype(np.float64)


def skewed(n: int, d: int = 2, seed: int = 0) -> np.ndarray:
    """Zipf-ish skew: coordinates concentrated near the origin."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, d)) ** 4
    return pts.astype(np.float64)


def osm_like(n: int, seed: int = 0) -> np.ndarray:
    """2-D: dense city clusters + sparse countryside + empty oceans."""
    rng = np.random.default_rng(seed)
    n_clusters = 64
    centers = rng.random((n_clusters, 2))
    # keep clusters on "land": reject centers in two ocean bands
    ocean = (centers[:, 0] < 0.18) | (
        (centers[:, 0] > 0.42) & (centers[:, 0] < 0.55)
    )
    centers[ocean, 0] = rng.random(ocean.sum()) * 0.25 + 0.6
    weights = rng.pareto(1.2, n_clusters) + 0.05
    weights /= weights.sum()
    n_cluster_pts = int(n * 0.85)
    counts = rng.multinomial(n_cluster_pts, weights)
    parts = []
    for c, k in zip(centers, counts):
        if k == 0:
            continue
        scale = rng.uniform(0.002, 0.03)
        parts.append(rng.normal(c, scale, size=(k, 2)))
    sprinkle = rng.random((n - n_cluster_pts, 2))
    sprinkle[:, 0] = sprinkle[:, 0] * 0.4 + 0.55  # countryside strip
    parts.append(sprinkle)
    pts = np.concatenate(parts)[:n]
    pts = np.clip(pts, 0.0, 1.0)
    return pts[np.random.default_rng(seed + 1).permutation(len(pts))].astype(
        np.float64
    )


def nycyt_like(n: int, d: int = 5, seed: int = 0) -> np.ndarray:
    """5-D correlated trips: (pickup_x, pickup_y, dropoff_x, dropoff_y, t).

    Pickups cluster around hotspots; dropoffs correlate with pickups (short
    trips dominate); time has rush-hour peaks.  ``d < 5`` selects the first
    d dimensions (paper Figure 9 protocol).
    """
    rng = np.random.default_rng(seed)
    hotspots = rng.random((12, 2)) * 0.6 + 0.2
    w = rng.pareto(1.5, 12) + 0.1
    w /= w.sum()
    which = rng.choice(12, size=n, p=w)
    pickup = hotspots[which] + rng.normal(0, 0.04, size=(n, 2))
    trip = rng.exponential(0.08, size=(n, 1)) * rng.normal(
        0, 1.0, size=(n, 2)
    )
    dropoff = pickup + trip
    peaks = np.array([0.35, 0.75])
    t = (
        peaks[rng.integers(0, 2, n)] + rng.normal(0, 0.1, n)
    ).reshape(n, 1)
    pts = np.concatenate([pickup, dropoff, t], axis=1)
    pts = np.clip(pts, 0.0, 1.0)
    return pts[:, :d].astype(np.float64)


GENERATORS = {
    "uniform": uniform,
    "gaussian": gaussian,
    "skewed": skewed,
    "osm": lambda n, seed=0: osm_like(n, seed),
    "nycyt": lambda n, seed=0, d=5: nycyt_like(n, d, seed),
}
