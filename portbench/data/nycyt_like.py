"""NYC yellow-taxi-like 5-D trips: (pickup x, pickup y, dropoff x,
dropoff y, time).

A copy of ``repro_torch.core.datasets.nycyt_like`` split in two.  The
configuration's ``shape_seed`` fixes the 12 pickup hotspots and their
Pareto(1.5) weights; the run's ``--seed`` draws the trips: pickups around
the hotspots, dropoffs a short exponential trip away, times around two
rush-hour peaks.
"""
from __future__ import annotations

import numpy as np

N_HOTSPOTS = 12
PEAKS = np.array([0.35, 0.75])


def structure(shape_seed: int, params: dict) -> dict:
    rng = np.random.default_rng(shape_seed)
    hotspots = rng.random((N_HOTSPOTS, 2)) * 0.6 + 0.2
    w = rng.pareto(1.5, N_HOTSPOTS) + 0.1
    return {"hotspots": hotspots, "weights": w / w.sum()}


def sample(st: dict, n: int, seed: int) -> np.ndarray:
    """``n`` float64 trips in [0, 1]^5."""
    rng = np.random.default_rng(seed)
    which = rng.choice(N_HOTSPOTS, size=n, p=st["weights"])
    pts = np.empty((n, 5))
    pts[:, :2] = st["hotspots"][which] + rng.normal(0, 0.04, size=(n, 2))
    trip = rng.exponential(0.08, size=(n, 1)) * rng.normal(0, 1.0, size=(n, 2))
    pts[:, 2:4] = pts[:, :2] + trip
    pts[:, 4] = PEAKS[rng.integers(0, 2, n)] + rng.normal(0, 0.1, n)
    np.clip(pts, 0.0, 1.0, out=pts)
    return pts
