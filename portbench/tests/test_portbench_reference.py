"""The plain reference agrees with repro_torch on the CPU at a small size,
and its control (the reference in bfloat16) fails the cells' limits."""
import json

import numpy as np
import pytest
import torch

from portbench import compare, harness, reference, traffic

N, Q = 20_000, 64
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
KIND = {name: traffic.load(w["traffic"])["kind"] for name, w in
        ((w["name"], w) for w in BENCH["workloads"])}


def _deployment(workload, seed):
    cell = harness.load_cell(workload)
    dep = harness.deploy(cell.config, seed, "cpu", Q, N)
    spec = dict(cell.traffic, queries_per_request=Q)
    return cell, dep, traffic.Traffic(spec, dep.points, seed)


@pytest.mark.parametrize("workload", [c for c in CELLS if KIND[c] == "window"])
def test_windows_agree_with_the_port(workload):
    _, dep, tr = _deployment(workload, 2**31 + 17)
    los, his = tr.request(0)
    got = dep.server.window(los, his)
    want = reference.window_ids(torch.from_numpy(dep.points), los, his)
    assert sum(len(w) for w in want) > Q
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.sort(g), w)


@pytest.mark.parametrize("workload", [c for c in CELLS if KIND[c] == "knn"])
def test_knn_agrees_with_the_port(workload):
    _, dep, tr = _deployment(workload, 2**31 + 19)
    qs = tr.request(0)
    pts = torch.from_numpy(dep.points)
    got = dep.server.knn(qs, tr.k)
    r = compare.knn_readings(pts, qs, got, tr.k)
    assert r["knn_bad_answers"] == 0 and r["knn_rank_gap"] < 1e-6


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_limits(workload):
    cell, dep, tr = _deployment(workload, 2**31 + 23)
    req = tr.request(0)
    sample = [(tr.query(req, j), a) for j, a in enumerate(tr.serve(dep.server, req))]
    pts = torch.from_numpy(dep.points)
    clean = {"faults": 0, "failed_requests": 0, "short_requests": 0}
    ok, checks = compare.judge({**compare.readings(tr.kind, pts, sample, tr.k), **clean},
                               cell.limits)
    assert ok, checks
    control = compare.control_answers(tr.kind, pts, sample, tr.k)
    ok, checks = compare.judge({**compare.readings(tr.kind, pts, control, tr.k), **clean},
                               cell.limits)
    assert not ok, checks
