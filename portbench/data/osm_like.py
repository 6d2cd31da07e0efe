"""OSM-like 2-D points: dense city clusters, a countryside strip, empty
oceans.

A copy of ``repro_torch.core.datasets.osm_like`` split in two.  The
configuration's ``shape_seed`` fixes the map: the 64 cluster centres (kept
off two ocean bands), their Pareto(1.2) weights and their scales.  The run's
``--seed`` draws only the points within that map.  With one seed for both,
the original function's single stream drew the scales inside its loop and
skipped empty clusters, so its points differ from these; the shape is the
same.
"""
from __future__ import annotations

import numpy as np

N_CLUSTERS = 64
CLUSTER_SHARE = 0.85


def structure(shape_seed: int, params: dict) -> dict:
    rng = np.random.default_rng(shape_seed)
    centers = rng.random((N_CLUSTERS, 2))
    ocean = (centers[:, 0] < 0.18) | ((centers[:, 0] > 0.42) & (centers[:, 0] < 0.55))
    centers[ocean, 0] = rng.random(int(ocean.sum())) * 0.25 + 0.6
    weights = rng.pareto(1.2, N_CLUSTERS) + 0.05
    weights /= weights.sum()
    scales = rng.uniform(0.002, 0.03, N_CLUSTERS)
    return {"centers": centers, "weights": weights, "scales": scales}


def sample(st: dict, n: int, seed: int) -> np.ndarray:
    """``n`` float64 points in [0, 1]^2, in a random order."""
    rng = np.random.default_rng(seed)
    n_cluster = int(n * CLUSTER_SHARE)
    counts = rng.multinomial(n_cluster, st["weights"])
    pts = np.empty((n, 2))
    which = np.repeat(np.arange(N_CLUSTERS), counts)
    pts[:n_cluster] = (st["centers"][which]
                       + rng.standard_normal((n_cluster, 2)) * st["scales"][which, None])
    sprinkle = rng.random((n - n_cluster, 2))
    sprinkle[:, 0] = sprinkle[:, 0] * 0.4 + 0.55  # countryside strip
    pts[n_cluster:] = sprinkle
    np.clip(pts, 0.0, 1.0, out=pts)
    return pts[rng.permutation(n)]
