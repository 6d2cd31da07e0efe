"""Grid-index parity: the port's ``core/grid_index.py`` against the JAX
package's ``core/jax_index.py`` (PyTorch port).

The same numpy inputs go through the JAX functions (jitted on the CPU, the
Pallas routing kernel in interpret mode) and through the port's, whose
index lives on the CPU here (``device="cpu"``), where every kernel runs as
its plain version.  Data is continuous (uniform) or duplicate-heavy grid
data (multiples of 1/8, so medians tie and every sum is exact).

Contract:
  * ``build`` and ``pad_points``: bitwise equal arrays;
  * ``route``, ``nearest_leaf`` (on grid data), ``window_count`` and
    ``window_count_candidates`` (counts and certificates, budgets below
    the straddle count included): equal;
  * ``knn``: distances bitwise equal on grid data and within rtol 1e-6
    otherwise (XLA's CPU compiler contracts ``acc + g * g`` into a fused
    multiply-add); certificates equal on grid data, and elsewhere where
    the two compared values are more than 1e-6 apart; ids equal on grid
    data (both select the lower flat index among equal distances), and
    equal as sets to a brute force's wherever the brute force's k-th
    distance is strictly below its (k+1)-th.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_index as JI
from repro.kernels import ops as jops
from repro_torch.core import grid_index as GI
from repro_torch.core import grid_index_from_arrays

ARRAYS = GI.GridIndex.ARRAYS


def _points(kind, n, d, seed):
    rng = np.random.default_rng(seed)
    if kind == "grid":
        return (rng.integers(0, 8, (n, d)) / 8.0).astype(np.float32)
    return rng.random((n, d)).astype(np.float32)


def _bits(x):
    x = np.ascontiguousarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_same_index(t, j):
    assert (t.levels, t.leaf_size) == (j.levels, j.leaf_size)
    for a in ARRAYS:
        got, want = getattr(t, a).numpy(), np.asarray(getattr(j, a))
        assert got.shape == want.shape, a
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=a)


_BUILT = {}


def _built(kind, d, levels, n=1000):
    """(points, JAX index, port index) built from the same padded points."""
    key = (kind, d, levels, n)
    if key not in _BUILT:
        pts = _points(kind, n, d, seed=d * 10 + levels)
        padded, ids = JI.pad_points(pts, levels)
        j = JI.build(jnp.asarray(padded), levels, jnp.asarray(ids, jnp.int32))
        t = GI.build(padded, levels, ids, device="cpu")
        _BUILT[key] = (pts, j, t)
    return _BUILT[key]


def _carried(j):
    return grid_index_from_arrays({a: np.asarray(getattr(j, a)) for a in ARRAYS},
                                  j.levels, j.leaf_size)


@pytest.mark.parametrize("kind", ["uniform", "grid"])
@pytest.mark.parametrize("d", [2, 3, 5])
@pytest.mark.parametrize("levels", [4, 6])
def test_build_is_bitwise_the_jax_build(kind, d, levels):
    pts, j, t = _built(kind, d, levels)
    _assert_same_index(t, j)
    assert t.device.type == "cpu" and t.row_ids.dtype == torch.int32
    assert t.n_leaves == 1 << levels
    # every real row appears once; padding rows carry -1
    rows = t.row_ids.numpy()
    np.testing.assert_array_equal(np.sort(rows[rows >= 0]), np.arange(len(pts)))


@pytest.mark.parametrize("n,levels", [(1000, 4), (1024, 6), (7, 3)])
def test_pad_points_matches_jax(n, levels):
    pts = _points("uniform", n, 3, seed=n)
    got, got_ids = GI.pad_points(pts, levels)
    want, want_ids = JI.pad_points(pts, levels)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(got_ids, want_ids)
    assert got.shape[0] % (1 << levels) == 0


def test_build_without_row_ids_and_bad_sizes():
    pts = _points("grid", 64, 2, seed=1)
    t = GI.build(torch.from_numpy(pts), 3, device="cpu")
    j = JI.build(jnp.asarray(pts), 3)
    _assert_same_index(t, j)
    with pytest.raises(ValueError, match="multiple of 2"):
        GI.build(pts[:60], 3, device="cpu")


@pytest.mark.parametrize("kind", ["uniform", "grid"])
@pytest.mark.parametrize("d", [2, 5])
def test_route_matches_jax_route_and_kernel(kind, d):
    pts, j, t = _built(kind, d, 6)
    rng = np.random.default_rng(d)
    qs = np.concatenate([pts, _points(kind, 200, d, seed=d + 1),
                         rng.random((50, d)).astype(np.float32) * 2 - 0.5])
    got = GI.route(t, qs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(JI.route(j, jnp.asarray(qs))))
    kern = jops.partition_assign(jnp.asarray(qs), j.split_dim, j.split_val,
                                 levels=j.levels, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(kern))
    # a built index routes each of its points into a leaf box holding it
    # (median ties may route a point into its left neighbour's box)
    g = got.numpy()[: len(pts)]
    lo, hi = t.leaf_lo.numpy()[g], t.leaf_hi.numpy()[g]
    inside = np.all((pts >= lo) & (pts <= hi), axis=1)
    assert inside.mean() > (0.5 if kind == "grid" else 0.99)


@pytest.mark.parametrize("d", [2, 3, 5])
def test_nearest_leaf_matches_jax_on_grid_data(d):
    pts, j, t = _built("grid", d, 6)
    qs = _points("grid", 300, d, seed=7 + d) * np.float32(1.25) - np.float32(0.1)
    got = GI.nearest_leaf(t, qs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JI.nearest_leaf(j, jnp.asarray(qs))))


def _windows(kind, nq, d, seed, half):
    c = _points(kind, nq, d, seed)
    return (c - np.float32(half)), (c + np.float32(half))


def _brute_counts(pts, los, his):
    return np.array([np.all((pts >= lo) & (pts <= hi), axis=1).sum()
                     for lo, hi in zip(los, his)])


@pytest.mark.parametrize("kind", ["uniform", "grid"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("half", [0.05, 0.25])
def test_window_count_matches_jax(kind, d, half):
    pts, j, t = _built(kind, d, 6)
    los, his = _windows(kind, 40, d, seed=3 + d, half=half)
    got = GI.window_count(t, los, his)
    want = np.asarray(JI.window_count(j, jnp.asarray(los), jnp.asarray(his)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _brute_counts(pts, los, his))
    # a starting budget below the need escalates to the same exact counts
    np.testing.assert_array_equal(
        GI.window_count(t, los, his, n_candidate_leaves=1).numpy(), want)


@pytest.mark.parametrize("kind", ["uniform", "grid"])
@pytest.mark.parametrize("budget", [1, 2, 3, 8, 64])
def test_window_count_candidates_matches_jax(kind, budget):
    """Budgets below the straddle count pick the same leaves (the lower
    index first among equal straddle scores), so the lower-bound counts
    and the certificates equal the JAX package's."""
    pts, j, t = _built(kind, 2, 6)
    los, his = _windows(kind, 48, 2, seed=11, half=0.2)
    cnt, exact = GI.window_count_candidates(t, los, his, budget)
    jc, je = JI.window_count_candidates(j, jnp.asarray(los), jnp.asarray(his), budget)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(exact.numpy(), np.asarray(je))
    want = _brute_counts(pts, los, his)
    assert np.all(cnt.numpy() <= want)
    np.testing.assert_array_equal(cnt.numpy()[exact.numpy()], want[exact.numpy()])
    if budget <= 2:
        assert not exact.numpy().all()


def _brute_d2(pts, q):
    acc = np.zeros(len(pts), dtype=np.float32)
    for k in range(pts.shape[1]):
        diff = pts[:, k] - q[k]
        acc = acc + diff * diff
    return acc


def _check_knn(pts, qs, k, got, want, grid, mind_gap):
    """Port ``(rows, d2, exact)`` against the JAX package's."""
    rows, d2, exact = (x.numpy() for x in got)
    jrows, jd2, jexact = (np.asarray(x) for x in want)
    assert rows.shape == d2.shape == (len(qs), k) and exact.shape == (len(qs),)
    if grid:
        np.testing.assert_array_equal(_bits(d2), _bits(jd2))
        np.testing.assert_array_equal(rows, jrows)
        np.testing.assert_array_equal(exact, jexact)
    else:
        np.testing.assert_allclose(d2, jd2, rtol=1e-6, atol=0)
        sure = mind_gap > 1e-6
        np.testing.assert_array_equal(exact[sure], jexact[sure])
    for i, q in enumerate(qs):
        if not exact[i]:
            continue
        full = np.sort(_brute_d2(pts, q))
        np.testing.assert_array_equal(d2[i], full[:k])
        if full[k - 1] < full[k]:
            want_ids = set(np.flatnonzero(_brute_d2(pts, q) <= full[k - 1]).tolist())
            assert set(rows[i].tolist()) == want_ids
            assert set(jrows[i].tolist()) == want_ids


def _mind_gap(t, qs, d2, n_c):
    """Relative gap between the k-th distance and the first unscanned
    leaf's mindist (where the certificate compares them)."""
    if n_c >= t.n_leaves:
        return np.full(len(qs), np.inf)
    mind = np.sort(GI.ops.leaf_mindist_tiled(torch.from_numpy(qs), t.leaf_lo,
                                             t.leaf_hi).numpy(), axis=1)[:, n_c]
    kth = d2.numpy()[:, -1]
    return np.abs(kth - mind) / np.maximum(np.abs(mind), 1e-30)


@pytest.mark.parametrize("kind", ["uniform", "grid"])
@pytest.mark.parametrize("d", [2, 3, 5])
@pytest.mark.parametrize("k,n_c", [(1, 2), (8, 4), (16, 64)])
def test_knn_on_built_index_matches_jax(kind, d, k, n_c):
    pts, j, t = _built(kind, d, 6)
    qs = _points(kind, 40, d, seed=20 + d)
    got = GI.knn(t, qs, k, n_candidate_leaves=n_c)
    want = JI.knn(j, jnp.asarray(qs), k, n_candidate_leaves=n_c)
    _check_knn(pts, qs, k, got, want, kind == "grid", _mind_gap(t, qs, got[1], n_c))
    if n_c >= t.n_leaves:
        assert got[2].all()


def test_knn_invalid_slots_are_inf_like_jax():
    """More neighbours than the index holds points: the rest are padding
    slots, returned as row -1 at distance +inf on both sides."""
    pts, j, t = _built("grid", 2, 6, n=200)     # 256 slots, 56 padding
    qs = _points("grid", 5, 2, seed=4)
    got = GI.knn(t, qs, 210, n_candidate_leaves=64)
    want = JI.knn(j, jnp.asarray(qs), 210, n_candidate_leaves=64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.isinf(got[1].numpy()).any() and (got[0].numpy() == -1).any()


@pytest.mark.parametrize("kind", ["uniform", "grid"])
@pytest.mark.parametrize("d", [2, 5])
def test_queries_on_a_carried_index_match_jax(kind, d):
    """The JAX index's own arrays carried across: every query function
    equals the JAX one on an identical index, whatever ``build`` did."""
    pts, j, _ = _built(kind, d, 4)
    t = _carried(j)
    _assert_same_index(t, j)
    qs = _points(kind, 30, d, seed=d)
    np.testing.assert_array_equal(GI.route(t, qs).numpy(),
                                  np.asarray(JI.route(j, jnp.asarray(qs))))
    los, his = _windows(kind, 30, d, seed=d + 5, half=0.15)
    np.testing.assert_array_equal(
        GI.window_count(t, los, his).numpy(),
        np.asarray(JI.window_count(j, jnp.asarray(los), jnp.asarray(his))))
    got = GI.knn(t, qs, 4, n_candidate_leaves=3)
    want = JI.knn(j, jnp.asarray(qs), 4, n_candidate_leaves=3)
    _check_knn(pts, qs, 4, got, want, kind == "grid", _mind_gap(t, qs, got[1], 3))


def test_grid_index_from_arrays_rejects_bad_shapes():
    _, j, _ = _built("grid", 2, 4)
    arrays = {a: np.asarray(getattr(j, a)) for a in ARRAYS}
    with pytest.raises(ValueError, match="missing"):
        grid_index_from_arrays({a: v for a, v in arrays.items() if a != "row_ids"},
                               j.levels, j.leaf_size)
    with pytest.raises(ValueError, match="shape"):
        grid_index_from_arrays(arrays, j.levels, j.leaf_size + 1)
    short = dict(arrays, split_dim=arrays["split_dim"][:-1],
                 split_val=arrays["split_val"][:-1])
    with pytest.raises(ValueError, match="levels"):
        grid_index_from_arrays(short, j.levels, j.leaf_size)


def test_to_device_and_defaults_need_a_card(monkeypatch):
    _, _, t = _built("grid", 2, 4)
    same = t.to("cpu")
    _assert_same_index(same, _built("grid", 2, 4)[1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t.to(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GI.build(np.zeros((16, 2), np.float32), 2)
