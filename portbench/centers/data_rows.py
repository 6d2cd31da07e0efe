"""Centres at data rows drawn uniformly: users query where the data is."""
from __future__ import annotations

import numpy as np


def make(spec: dict, points: np.ndarray, config: dict):
    n = len(points)
    return lambda rng, q: points[rng.integers(0, n, q)]
