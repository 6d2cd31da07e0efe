"""A configuration's ``shape_seed`` fixes the map; ``--seed`` draws only
the points within it, and the requests."""
import numpy as np
import pytest

from portbench import harness, traffic
from portbench.data import nycyt_like, osm_like

CONFIGS = {"osm_like": osm_like, "nycyt_like": nycyt_like}


@pytest.mark.parametrize("gen", sorted(CONFIGS))
def test_shape_seed_fixes_the_structure_and_seed_the_points(gen):
    mod = CONFIGS[gen]
    a, b = mod.structure(7, {}), mod.structure(7, {})
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    other = mod.structure(8, {})
    assert any(not np.array_equal(a[k], other[k]) for k in a)
    p1, p2 = mod.sample(a, 5000, [11, 0]), mod.sample(a, 5000, [12, 0])
    assert p1.shape == p2.shape and not np.array_equal(p1, p2)
    np.testing.assert_array_equal(p1, mod.sample(a, 5000, [11, 0]))
    assert ((p1 >= 0) & (p1 <= 1)).all()


def test_two_seeds_share_the_map():
    """At the same structure, cluster shares agree to sampling noise."""
    st = osm_like.structure(7, {})
    near = []
    for seed in (1, 2):
        pts = osm_like.sample(st, 200_000, [seed, 0])
        d2 = ((pts[:, None, :] - st["centers"][None]) ** 2).sum(-1)
        near.append(np.bincount(d2.argmin(1), minlength=64) / len(pts))
    assert np.abs(near[0] - near[1]).max() < 0.01


def test_points_and_requests_are_float32_values():
    cell = harness.load_cell("osm2d.window")
    pts = harness.make_points(cell.config, 2**31 + 5, 4000)
    np.testing.assert_array_equal(pts, pts.astype(np.float32).astype(np.float64))
    tr = traffic.Traffic(cell.traffic, pts, 2**31 + 5)
    lo, hi = tr.request(3)
    np.testing.assert_array_equal(lo, lo.astype(np.float32))
    assert (hi > lo).all()
    np.testing.assert_array_equal(lo, traffic.Traffic(cell.traffic, pts, 2**31 + 5).request(3)[0])
    assert not np.array_equal(lo, tr.request(4)[0])
