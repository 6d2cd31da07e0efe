"""Where queries fall: ``data_rows`` draws every request as the benchmark
always has, and ``focused`` draws inside a box that the map fixes."""
import json

import numpy as np
import pytest

from portbench import harness, traffic
from portbench.centers import focused

SEED = 2**31 + 43
N = 20_000


def _f32(a):
    return a.astype(np.float32).astype(np.float64)


def _request_before_centre_kinds(spec, points, seed, i, stream):
    """Request ``i`` as ``traffic.Traffic.request`` drew it before centre
    kinds were modules: the formula that every cell's requests follow."""
    rng = np.random.default_rng([int(seed) % 2**64, 1 + stream, i])
    c = points[rng.integers(0, len(points), int(spec["queries_per_request"]))]
    n, d = points.shape
    hw = 0.5 * (spec["area_per_n"] / n) ** (1.0 / d)
    if spec["kind"] == "window":
        return _f32(c - hw), _f32(c + hw)
    return _f32(c + rng.uniform(-hw, hw, size=c.shape))


@pytest.mark.parametrize("workload", ["osm2d.window", "osm2d.knn", "nycyt5d.window",
                                      "nycyt5d.knn"])
def test_data_rows_requests_are_unchanged(workload):
    cell = harness.load_cell(workload)
    pts = harness.make_points(cell.config, SEED, N)
    spec = dict(cell.traffic, queries_per_request=128)
    tr = traffic.Traffic(spec, pts, SEED, cell.config)
    for stream in (traffic.WINDOW_STREAM, traffic.WARMUP_STREAM, traffic.TRACE_STREAM):
        for i in (0, 1, 7, 1000, 2**20 + 3):
            got = tr.request(i, stream)
            want = _request_before_centre_kinds(spec, pts, SEED, i, stream)
            for g, w in zip(got if spec["kind"] == "window" else [got],
                            want if spec["kind"] == "window" else [want]):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("config,side", [("osm2d-10m", 0.06),
                                         ("nycyt5d-10m", [0.3, 0.3, 0.3, 0.3, 0.3])])
def test_the_focus_box_is_fixed_by_the_map(config, side):
    cfg = json.loads((harness.ROOT / f"portbench/configs/{config}.json").read_text())
    spec = {"kind": "window", "center": "focused", "focus_side": side,
            "queries_per_request": 256, "area_per_n": 64}
    lo, hi = focused.focus_box(spec, cfg)
    np.testing.assert_allclose(hi - lo, np.broadcast_to(side, lo.shape))
    for seed in (SEED, SEED + 1):
        pts = harness.make_points(cfg, seed, N)
        tr = traffic.Traffic(spec, pts, seed, cfg)
        a, b = tr.request(3)
        c = (a + b) / 2
        assert ((c >= lo - 1e-6) & (c <= hi + 1e-6)).all()
        inside = ((pts >= lo) & (pts <= hi)).all(axis=1)
        # the box lies where the map is dense, so it holds many rows
        assert inside.mean() > 0.05
    np.testing.assert_array_equal(focused.focus_box(spec, cfg)[0], lo)
    other = dict(cfg, shape_seed=cfg["shape_seed"] + 1)
    assert not np.array_equal(focused.focus_box(spec, other)[0], lo)
