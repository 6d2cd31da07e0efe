"""Rank entry functions for the port's collective tests.

``mesh.run_ranks`` spawns each rank from a fresh interpreter that imports
the module of the function it runs, so these live apart from the test
files (which import JAX and the JAX package): a rank imports torch, numpy
and the port only.  Each function returns host NumPy data.
"""
import time

import numpy as np

from repro_torch.core import distributed as D
from repro_torch.core import distributed_torch as DT
from repro_torch.core import mesh
from repro_torch.kernels import launches


def collective_case(group, path, datasets, rounds, levels, k, n_cand):
    """``shard_build`` and ``shard_knn`` over each dataset of
    ``path/inputs.npz`` (rank r takes rows ``r*per .. (r+1)*per``), then
    both collective rounds over each stacked layout of ``rounds`` saved
    for this world size.  Returns, per dataset, this rank's build arrays,
    its dropped count and the merged k-NN answers (of the dataset's
    queries and of ``far_qs``), per round set the rounds' answers, and the
    kernel launches and host bytes staged of the run."""
    data = np.load(f"{path}/inputs.npz")
    m, r = group.size, group.rank
    launches.reset()
    out = {}
    for name in datasets:
        pts = data[name]
        per = len(pts) // m
        local = D.shard_build(pts[r * per:(r + 1) * per], levels, group)
        out[name] = {"arrays": local.arrays(), "n_dropped": local.n_dropped}
        for key, qs in (("knn", data[f"{name}_qs"]), ("knn_far", data["far_qs"])):
            res = D.shard_knn(local.index, qs, k, group, n_candidate_leaves=n_cand)
            out[name][key] = tuple(t.cpu().numpy() for t in res)
    out["rounds"] = {}
    t0 = time.perf_counter()
    for tag in rounds:
        pre = f"stacked.{m}.{tag}."
        stacked = {key[len(pre):]: data[key] for key in data.files if key.startswith(pre)}
        out["rounds"][tag] = {
            "knn_batch": DT.knn_batch_shard_map(stacked, data[f"{tag}_qs"], k, group),
            "knn_batch_far": DT.knn_batch_shard_map(stacked, data["far_qs"], k, group),
            "window_count": DT.window_count_batch_shard_map(
                stacked, data[f"{tag}_los"], data[f"{tag}_his"], group),
        }
    out["rounds_s"] = time.perf_counter() - t0
    out["launches"] = launches.counts()
    out["staged_bytes"] = group.staged_bytes
    out["seconds"] = dict(group.seconds)
    return out


def fail_in_collective(group, how):
    """Rank 1 fails while rank 0 waits in an ``all_gather``: it raises, or
    exits at once without a report, or hangs."""
    import os

    import torch

    if group.rank == 1:
        if how == "raise":
            raise RuntimeError("injected rank failure")
        if how == "exit":
            os._exit(3)
        time.sleep(3600)
    return mesh.all_gather(group, torch.ones(2)).numpy()


def nan_knn_case(group, path, levels, k, n_cand):
    """``shard_build`` over ``path/inputs.npz``'s ``pts`` (rank r takes rows
    ``r*per .. (r+1)*per``), then ``shard_knn`` over its ``qs``.  Returns
    this rank's row ids and the merged answer ``(d2, rows, source)``."""
    data = np.load(f"{path}/inputs.npz")
    pts = data["pts"]
    m, r = group.size, group.rank
    per = len(pts) // m
    local = D.shard_build(pts[r * per:(r + 1) * per], levels, group)
    res = D.shard_knn(local.index, data["qs"], k, group, n_candidate_leaves=n_cand)
    return {"row_ids": local.index.row_ids.cpu().numpy(),
            "knn": tuple(t.cpu().numpy() for t in res[:3])}
