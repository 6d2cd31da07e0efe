"""Retrieval-server parity: the port's ``serve.RetrievalServer`` against
the JAX package's (PyTorch port).

The same points go to both servers; the port's lives on the CPU here
(``device="cpu"``), where every kernel runs as its plain version.  Data is
``osm_like`` (continuous) or the same points snapped to a 1/256 grid
(every distance sum exact).

Contract: ``knn`` as in ``test_torch_grid_index.py`` (distances bitwise on
grid data, rtol 1e-6 otherwise; ids equal on grid data); ``knn_kernel``
distances within ``tests/test_kernels.py``'s tolerance of the JAX
server's (the Pallas distance tiles compute ``|q|^2+|p|^2-2q.p``, the
port the direct sum) and bitwise equal to a float32 brute force; adaptive
residency gives the same hot set, in the same order, and the same
``RetrievalStats``; ``from_snapshot`` boots from a snapshot that the JAX
package's ``Index.save`` wrote.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PageStore as JaxPageStore
from repro.core import bulk_load as jax_bulk_load
from repro.core import jax_index as JI
from repro.core.datasets import osm_like
from repro.serve.engine import RetrievalServer as JaxServer
from repro_torch.core import grid_index as GI
from repro_torch.core import grid_index_from_arrays
from repro_torch.serve import RetrievalServer, RetrievalStats


def _pts(kind, n, seed):
    pts = osm_like(n, seed=seed)
    if kind == "grid":
        pts = np.round(pts * 256) / 256
    return pts


def _servers(kind, n=4096, levels=5, **kw):
    pts = _pts(kind, n, seed=1)
    return pts, JaxServer(pts, levels, **kw), RetrievalServer(pts, levels, device="cpu", **kw)


def _brute_d2(pts32, q):
    acc = np.zeros(len(pts32), dtype=np.float32)
    for k in range(pts32.shape[1]):
        diff = pts32[:, k] - q[k]
        acc = acc + diff * diff
    return acc


def _bits(x):
    return np.ascontiguousarray(x).view(np.int32)


@pytest.mark.parametrize("kind", ["uniform", "grid"])
def test_server_index_equals_the_jax_servers(kind):
    _, j, t = _servers(kind)
    assert t.index.device.type == "cpu" and t._routed
    for a in GI.GridIndex.ARRAYS:
        want = np.asarray(getattr(j.index, a))
        got = getattr(t.index, a).numpy()
        np.testing.assert_array_equal(got.view(np.int32) if got.dtype == np.float32
                                      else got, want.view(np.int32)
                                      if want.dtype == np.float32 else want)


@pytest.mark.parametrize("kind", ["uniform", "grid"])
@pytest.mark.parametrize("k,n_c", [(8, 12), (3, 2)])
def test_knn_matches_the_jax_server(kind, k, n_c):
    pts, j, t = _servers(kind)
    qs = _pts(kind, 16, seed=2).astype(np.float32)
    rows, d2, exact = t.knn(qs, k, n_candidate_leaves=n_c)
    jrows, jd2, jexact = j.knn(qs, k, n_candidate_leaves=n_c)
    assert rows.shape == d2.shape == (16, k) and exact.dtype == bool
    if kind == "grid":
        np.testing.assert_array_equal(_bits(d2), _bits(jd2))
        np.testing.assert_array_equal(rows, jrows)
        np.testing.assert_array_equal(exact, jexact)
    else:
        np.testing.assert_allclose(d2, jd2, rtol=1e-6, atol=0)
    pts32 = pts.astype(np.float32)
    for i, q in enumerate(qs):
        if exact[i]:
            full = np.sort(_brute_d2(pts32, q))
            np.testing.assert_array_equal(d2[i], full[:k])


@pytest.mark.parametrize("kind", ["uniform", "grid"])
def test_knn_kernel_matches_the_jax_server(kind):
    pts, j, t = _servers(kind)
    qs = _pts(kind, 8, seed=3).astype(np.float32)
    idx, d2 = t.knn_kernel(qs, 8)
    jidx, jd2 = j.knn_kernel(qs, 8)
    np.testing.assert_allclose(d2, jd2, rtol=1e-4, atol=1e-5)
    rows = t.index.row_ids.numpy()[idx]
    pts32 = pts.astype(np.float32)
    for i, q in enumerate(qs):
        full = _brute_d2(pts32, q)
        want = np.sort(full)
        np.testing.assert_array_equal(d2[i], want[:8])
        np.testing.assert_array_equal(full[rows[i]], d2[i])
        if want[7] < want[8]:
            assert set(rows[i].tolist()) == set(np.flatnonzero(full <= want[7]).tolist())
            assert set(np.asarray(j.index.row_ids)[jidx[i]].tolist()) == set(rows[i].tolist())


def test_knn_kernel_chunks_the_queries(monkeypatch):
    """Past ``KNN_MAX_ELEMS`` the queries run in chunks; the answer is the
    unchunked one."""
    from repro_torch.kernels import ops

    _, _, t = _servers("grid")
    qs = np.random.default_rng(5).random((40, 2)).astype(np.float32)
    whole = t.knn_kernel(qs, 6)
    calls = []
    real = ops.pairwise_dist2
    monkeypatch.setattr(ops, "pairwise_dist2",
                        lambda q, *a: calls.append(len(q)) or real(q, *a))
    monkeypatch.setattr(ops, "KNN_MAX_ELEMS", 16 * t.index.points_sorted.shape[0])
    chunked = t.knn_kernel(qs, 6)
    assert calls == [16, 16, 8]
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a, b)


def _stream(server, rng, focused, batches=30):
    for _ in range(batches):
        if focused:
            qs = (rng.random((16, 2)) * 0.05 + 0.6).astype(np.float32)
        else:
            qs = rng.random((16, 2)).astype(np.float32)
        server.knn(qs, 4)


@pytest.mark.parametrize("focused", [True, False])
def test_adaptive_residency_matches_the_jax_server(focused):
    pts = _pts("uniform", 20_000, seed=3)
    j = JaxServer(pts, levels=6, adaptive=True, hot_capacity=8)
    t = RetrievalServer(pts, levels=6, adaptive=True, hot_capacity=8, device="cpu")
    _stream(j, np.random.default_rng(4), focused)
    _stream(t, np.random.default_rng(4), focused)
    assert list(t.hot.items()) == list(j.hot.items())
    assert (t.stats.queries, t.stats.hot_hits, t.stats.cold_misses) == (
        j.stats.queries, j.stats.hot_hits, j.stats.cold_misses)
    assert t.tick == j.tick == 30 * 16
    assert isinstance(t.stats, RetrievalStats)


def test_focused_stream_hits_more_than_uniform():
    pts = _pts("uniform", 20_000, seed=3)
    rng = np.random.default_rng(4)
    rates = []
    for focused in (True, False):
        srv = RetrievalServer(pts, levels=6, adaptive=True, hot_capacity=8, device="cpu")
        _stream(srv, rng, focused)
        rates.append(srv.stats.hit_rate)
    assert rates[0] > rates[1] + 0.2
    assert RetrievalStats().hit_rate == 0.0


@pytest.fixture(scope="module")
def jax_snapshot(tmp_path_factory):
    pts = osm_like(8_000, seed=7)
    idx = jax_bulk_load(pts, 250, JaxPageStore(250))
    snap = tmp_path_factory.mktemp("snap") / "index.npz"
    idx.save(snap)
    return pts, snap, idx


def test_from_snapshot_bridges_like_the_jax_server(jax_snapshot):
    pts, snap, idx = jax_snapshot
    t = RetrievalServer.from_snapshot(snap, adaptive=True, hot_capacity=16, device="cpu")
    j = JaxServer.from_snapshot(snap, adaptive=True, hot_capacity=16)
    assert not t._routed and t.index.device.type == "cpu"
    for a in GI.GridIndex.ARRAYS:
        got, want = getattr(t.index, a).numpy(), np.asarray(getattr(j.index, a))
        np.testing.assert_array_equal(got, want, err_msg=a)
    assert (t.index.levels, t.index.leaf_size) == (j.index.levels, j.index.leaf_size)
    # the port's own table bridges to the same grid
    from repro_torch.core import NodeTable

    table, _, points = NodeTable.load(snap)
    own = table.to_grid_index(points)
    for a in GI.GridIndex.ARRAYS:
        np.testing.assert_array_equal(getattr(own, a).numpy(), np.asarray(getattr(j.index, a)))
    qs = np.random.default_rng(5).random((16, 2)).astype(np.float32)
    rows, d2, exact = t.knn(qs, 8, n_candidate_leaves=24)
    jrows, jd2, jexact = j.knn(qs, 8, n_candidate_leaves=24)
    np.testing.assert_allclose(d2, jd2, rtol=1e-6, atol=0)
    pts32 = pts.astype(np.float32)
    for i, q in enumerate(qs):
        if exact[i]:
            full = np.sort(_brute_d2(pts32, q))
            np.testing.assert_array_equal(d2[i], full[:8])
    assert t.stats.queries == 16
    assert list(t.hot) == list(j.hot)                    # via nearest_leaf
    los, his = qs[:4] - np.float32(0.05), qs[:4] + np.float32(0.05)
    got = GI.window_count(t.index, los, his).numpy()
    want = [int(np.all((pts32 >= lo) & (pts32 <= hi), axis=1).sum())
            for lo, hi in zip(los, his)]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(JI.window_count(j.index, jnp.asarray(los), jnp.asarray(his))))


def test_from_snapshot_needs_points(tmp_path):
    from repro_torch.core import bulk_load, PageStore

    pts = osm_like(3000, seed=2)
    idx = bulk_load(pts, 60, PageStore(60))
    snap = tmp_path / "nopts.npz"
    idx.table.save(snap)
    with pytest.raises(ValueError, match="without points"):
        RetrievalServer.from_snapshot(snap, device="cpu")


@pytest.mark.parametrize("kind", ["uniform", "grid"])
def test_grid_index_from_arrays_round_trips(kind):
    """A JAX index carried across answers like the port's own build."""
    _, j, t = _servers(kind)
    carried = grid_index_from_arrays(
        {a: np.asarray(getattr(j.index, a)) for a in GI.GridIndex.ARRAYS},
        j.index.levels, j.index.leaf_size)
    for a in GI.GridIndex.ARRAYS:
        assert torch.equal(getattr(carried, a), getattr(t.index, a)), a
    qs = np.random.default_rng(6).random((10, 2)).astype(np.float32)
    for g, w in zip(GI.knn(carried, qs, 5), GI.knn(t.index, qs, 5)):
        assert torch.equal(g, w)
