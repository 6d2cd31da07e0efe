"""The comparison that decides ``correct``.

Every number is computed from answers the timed path returned (a sample
drawn from the seed, once the window has closed) against the plain
reference (``reference.py``) over the same points, and is held to the
limit in the cell's file ``cells/<workload>.json``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import reference


def window_mismatches(points: torch.Tensor, los, his, answers) -> int:
    """Ids missing from or extra to each window's answer (a repeated id
    counts as extra), summed over the windows."""
    want = reference.window_ids(points, los, his)
    bad = 0
    for got, ref in zip(answers, want):
        got = np.asarray(got, dtype=np.int64)
        bad += got.size + ref.size - 2 * np.intersect1d(got, ref).size
    return int(bad)


def knn_readings(points: torch.Tensor, qs, answers, k: int) -> dict:
    """``knn_rank_gap``: the widest gap, over the sampled queries and the
    ranks, between the j-th smallest float64 squared distance of the
    answer's ids and the reference's j-th, as a share of the reference's
    k-th.  ``knn_bad_answers``: answers that are not ``min(k, n)`` distinct
    ids of points."""
    n = points.shape[0]
    m = min(k, n)
    want = reference.knn_dists(points, qs, reference.knn_ids(points, qs, k))
    got = reference.knn_dists(points, qs, answers)
    gap, bad = 0.0, 0
    for ids, g, w in zip(answers, got, want):
        ids = np.asarray(ids, dtype=np.int64)
        if (ids.size != m or np.unique(ids).size != m or ids.min(initial=0) < 0
                or ids.max(initial=0) >= n):
            bad += 1
            continue
        scale = max(w[-1], np.finfo(np.float64).tiny)
        gap = max(gap, float(np.max(np.abs(g - w)) / scale))
    return {"knn_rank_gap": gap, "knn_bad_answers": bad}


def readings(kind: str, points: torch.Tensor, sample: list, k: int | None) -> dict:
    """The numbers of one traffic kind over ``sample``: a list of
    ``(query, answer)`` with ``query`` a (lo, hi) pair or a point."""
    if not sample:
        return {}
    if kind == "window":
        los = np.stack([q[0] for q, _ in sample])
        his = np.stack([q[1] for q, _ in sample])
        return {"window_ids_mismatched": window_mismatches(
            points, los, his, [a for _, a in sample])}
    qs = np.stack([q for q, _ in sample])
    return knn_readings(points, qs, [a for _, a in sample], k)


def control_answers(kind: str, points: torch.Tensor, sample: list, k: int | None):
    """The control: the reference in bfloat16, one precision below the
    configured float32, answering the sampled queries in the program's
    place."""
    if kind == "window":
        los = np.stack([q[0] for q, _ in sample])
        his = np.stack([q[1] for q, _ in sample])
        ans = reference.window_ids(points, los, his, dtype=torch.bfloat16)
    else:
        qs = np.stack([q for q, _ in sample])
        ans = reference.knn_ids(points, qs, k, dtype=torch.bfloat16)
    return [(q, a) for (q, _), a in zip(sample, ans)]


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; ``correct`` when every number the
    limits name is present and within its limit."""
    checks = {name: {"value": numbers.get(name), "limit": lim}
              for name, lim in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
