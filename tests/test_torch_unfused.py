"""The port's first-generation (``fused=False``) engine against the JAX
package's (PyTorch port, ``core/queries_torch.py``).

The same numpy inputs go through ``window_query_batch_jax`` /
``knn_query_batch_jax(..., fused=False)`` (jnp arithmetic on the CPU; one
small case with ``use_kernel=True``, where ``window_mask_gathered`` and
``gathered_dist2`` run as Pallas kernels in interpret mode) and through the
port with ``fused=False`` on an export that lives on the CPU
(``device="cpu"``), where every kernel runs as its plain version.

Contract (as ``tests/test_torch_queries.py``):
  * windows: equal id sets, against the JAX engine and a brute force; the
    cold masks of a partial export are equal;
  * k-NN: distances equal a float32 brute force computed per dimension in
    the kernels' order, exactly; against the JAX engine they are equal on
    grid data and within rtol 1e-6 on continuous data (XLA's CPU compiler
    contracts a + b * c into a fused multiply-add); ids must equal the
    brute force's only where its k-th distance is strictly below its
    (k+1)-th;
  * the port's fused and first-generation engines return the same window
    id sets and the same k-NN distances on the same export.
"""
import numpy as np
import pytest
import torch

from repro.core import AMBI, window_oracle
from repro.core import queries_jax as QJ
from repro.core.queries_jax import DeviceTable as JaxTable
from repro.core.queries_jax import knn_query_batch_jax, window_query_batch_jax
from repro_torch.core import (
    DeviceTable,
    PageStore,
    bulk_load,
    index_from_arrays,
    knn_query_batch_torch,
    window_query_batch_torch,
)
from repro_torch.core import queries_torch as QT
from repro_torch.kernels import launches

from engines import build_fmbi, build_grafted_ambi, f32_points

M = 120


def _port_fmbi(pts):
    return bulk_load(pts, M, PageStore(M))


def _carried(ref_index, pts):
    cols = {c: getattr(ref_index.table, c) for c in QT.NodeTable.COLUMNS}
    return index_from_arrays(cols, pts, buffer_pages=M)


def _indexes(kind, d, seed, source):
    """(points, reference index, port index): FMBI built on each side, or
    the JAX package's grafted AMBI carried across."""
    pts = f32_points(3000, d, seed, kind)
    if source == "fmbi":
        return pts, build_fmbi(pts, M), _port_fmbi(pts)
    ref = build_grafted_ambi(pts, M)
    return pts, ref, _carried(ref, pts)


def _queries(rng, n, d, kind):
    if kind == "grid":
        return (rng.integers(0, 48, (n, d)) / 64.0).astype(np.float32)
    return rng.random((n, d)).astype(np.float32)


def _windows(rng, n, d, kind):
    c = _queries(rng, n, d, kind)
    w = rng.choice([0.01, 0.05, 0.2, 0.6], size=(n, 1)).astype(np.float32)
    return (c - w).astype(np.float32), (c + w).astype(np.float32)


def _brute_d2(pts32, q):
    acc = np.zeros(len(pts32), dtype=np.float32)
    for k in range(pts32.shape[1]):
        diff = pts32[:, k] - q[k]
        acc = acc + diff * diff
    return acc


def _check_knn(pts32, q, ids, d2, k, jax_d2, exact_jax):
    full = _brute_d2(pts32, q)
    m = min(k, len(full))
    order = np.argsort(full, kind="stable")[: m + 1]
    assert len(ids) == m and len(d2) == m and ids.dtype == np.int64
    np.testing.assert_array_equal(d2, full[order[:m]])
    np.testing.assert_array_equal(full[ids], d2)
    if m < len(full) and full[order[m - 1]] < full[order[m]]:
        assert set(ids.tolist()) == set(order[:m].tolist())
    if exact_jax:
        np.testing.assert_array_equal(d2, jax_d2)
    else:
        np.testing.assert_allclose(d2, jax_d2, rtol=1e-6, atol=0)


def _same_windows(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.sort(x), np.sort(y))


@pytest.mark.parametrize("source", ["fmbi", "ambi"])
@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("kind", ["uniform", "grid", "skew"])
def test_unfused_window_parity(kind, compressed, source):
    pts, ref, got = _indexes(kind, 2, 3, source)
    jdev = JaxTable.from_index(ref, compressed=compressed)
    tdev = DeviceTable.from_index(got, compressed=compressed, device="cpu")
    los, his = _windows(np.random.default_rng(7), 24, 2, kind)
    port = window_query_batch_torch(tdev, los, his, fused=False)
    jax_res = window_query_batch_jax(jdev, los, his, fused=False)
    assert len(port) == 24 and all(r.dtype == np.int64 for r in port)
    _same_windows(port, jax_res)
    for i in range(24):
        np.testing.assert_array_equal(np.sort(port[i]),
                                      window_oracle(pts, los[i], his[i]))


@pytest.mark.parametrize("source", ["fmbi", "ambi"])
@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("kind", ["uniform", "grid", "skew"])
def test_unfused_knn_parity(kind, compressed, source):
    d = 3 if kind == "skew" else 2
    pts, ref, got = _indexes(kind, d, 4, source)
    jdev = JaxTable.from_index(ref, compressed=compressed)
    tdev = DeviceTable.from_index(got, compressed=compressed, device="cpu")
    qs = _queries(np.random.default_rng(9), 16, d, kind)
    pts32 = pts.astype(np.float32)
    for k in (1, 40):
        ids, d2 = knn_query_batch_torch(tdev, qs, k, fused=False, return_dists=True)
        _, jd2 = knn_query_batch_jax(jdev, qs, k, fused=False, return_dists=True)
        for i in range(len(qs)):
            _check_knn(pts32, qs[i], ids[i], d2[i], k, jd2[i], kind == "grid")


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("kind", ["uniform", "grid"])
def test_unfused_knn_starved_budget(kind, compressed):
    """A budget of one leaf escalates in the host loop until certified."""
    pts, ref, got = _indexes(kind, 2, 15, "fmbi")
    jdev = JaxTable.from_index(ref, compressed=compressed)
    tdev = DeviceTable.from_index(got, compressed=compressed, device="cpu")
    qs = _queries(np.random.default_rng(5), 20, 2, kind)
    ids, d2, exact = knn_query_batch_torch(tdev, qs, 20, fused=False,
                                           n_candidate_leaves=1,
                                           return_dists=True, return_exact=True)
    _, jd2, jexact = knn_query_batch_jax(jdev, qs, 20, fused=False,
                                         n_candidate_leaves=1,
                                         return_dists=True, return_exact=True)
    assert exact.all() and jexact.all()
    for i in range(len(qs)):
        _check_knn(pts.astype(np.float32), qs[i], ids[i], d2[i], 20, jd2[i],
                   kind == "grid")


@pytest.mark.parametrize("compressed", [False, True])
def test_unfused_kernel_route_small(compressed):
    """The JAX first-generation engine with its Pallas kernels (interpret
    mode) against the port's on one small FMBI table."""
    pts = f32_points(1200, 2, 21, "grid")
    ref, got = build_fmbi(pts, M), _port_fmbi(pts)
    rng = np.random.default_rng(2)
    c = _queries(rng, 5, 2, "grid")
    los, his = c - np.float32(0.05), c + np.float32(0.05)
    qs = _queries(rng, 5, 2, "grid")
    jdev = JaxTable.from_index(ref, compressed=compressed)
    tdev = DeviceTable.from_index(got, compressed=compressed, device="cpu")
    _same_windows(window_query_batch_torch(tdev, los, his, fused=False),
                  window_query_batch_jax(jdev, los, his, fused=False, use_kernel=True))
    _, jd2 = knn_query_batch_jax(jdev, qs, 5, fused=False, use_kernel=True,
                                 return_dists=True)
    _, td2 = knn_query_batch_torch(tdev, qs, 5, fused=False, return_dists=True)
    for x, y in zip(jd2, td2):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("compressed", [False, True])
def test_fused_engine_matches_unfused(compressed):
    """The port's two engines on the same export: the same window id sets
    and k-NN distance sequences, with a starved k-NN budget and an odd
    batch."""
    pts = f32_points(5000, 3, 71, "skew")
    dev = DeviceTable.from_index(_port_fmbi(pts), compressed=compressed, device="cpu")
    ctr = np.random.default_rng(72).random((19, 3)).astype(np.float32)
    los, his = ctr - np.float32(0.06), ctr + np.float32(0.06)
    _same_windows(window_query_batch_torch(dev, los, his, fused=False),
                  window_query_batch_torch(dev, los, his, fused=True))
    ids0, d0, e0 = knn_query_batch_torch(dev, ctr, 10, fused=False, n_candidate_leaves=1,
                                         return_dists=True, return_exact=True)
    ids1, d1, e1 = knn_query_batch_torch(dev, ctr, 10, fused=True, n_candidate_leaves=1,
                                         return_dists=True, return_exact=True)
    assert e0.all() and e1.all()
    for i in range(len(ctr)):
        np.testing.assert_array_equal(d0[i], d1[i])
        _check_knn(pts.astype(np.float32), ctr[i], ids0[i], d0[i], 10, d1[i], True)


def test_unfused_partial_export_return_cold():
    pts = f32_points(20_000, 2, 5)
    ambi = AMBI(pts, 40)
    rng = np.random.default_rng(0)
    for _ in range(3):  # refine a few subspaces only
        c = rng.random(2) * 0.2 + 0.4
        ambi.window(c - 0.03, c + 0.03)
    assert not ambi.is_fully_refined()
    ref = ambi.index
    got = _carried(ref, pts)
    jdev = JaxTable.from_table(ref.table, pts, partial=True)
    tdev = DeviceTable.from_table(got.table, pts, partial=True, device="cpu")
    assert tdev.n_cold == jdev.n_cold > 0
    c = (rng.random((16, 2)) * 0.4 + 0.3).astype(np.float32)
    los, his = c - np.float32(0.05), c + np.float32(0.05)
    a, a_cold = window_query_batch_jax(jdev, los, his, fused=False, return_cold=True)
    b, b_cold = window_query_batch_torch(tdev, los, his, fused=False, return_cold=True)
    assert b_cold.shape == (16, tdev.n_cold) and b_cold.dtype == bool
    np.testing.assert_array_equal(b_cold, a_cold)
    assert b_cold.any() and not b_cold.all()
    _same_windows(a, b)
    f, f_cold = window_query_batch_torch(tdev, los, his, fused=True, return_cold=True)
    np.testing.assert_array_equal(f_cold, b_cold)
    _same_windows(f, b)
    qs = rng.random((8, 2)).astype(np.float32)
    _, jd2 = knn_query_batch_jax(jdev, qs, 5, fused=False, return_dists=True)
    _, td2 = knn_query_batch_torch(tdev, qs, 5, fused=False, return_dists=True)
    for x, y in zip(jd2, td2):
        np.testing.assert_allclose(y, x, rtol=1e-6, atol=0)


def test_unfused_all_cold_export_returns_empty():
    pts = f32_points(1000, 2, 6)
    ambi = AMBI(pts, M)
    tdev = DeviceTable.from_table(_carried(ambi.index, pts).table, pts,
                                  partial=True, device="cpu")
    assert tdev.n_leaves == 0 and tdev.n_cold == 1
    res, cold = window_query_batch_torch(tdev, [[0.1, 0.1]], [[0.4, 0.4]],
                                         fused=False, return_cold=True)
    assert len(res[0]) == 0 and res[0].dtype == np.int64 and cold.tolist() == [[True]]
    ids, d2, exact = knn_query_batch_torch(tdev, [[0.5, 0.5]], 3, fused=False,
                                           return_dists=True, return_exact=True)
    assert len(ids[0]) == 0 and len(d2[0]) == 0 and exact.tolist() == [True]


def test_unfused_max_rounds_zero_matches_jax():
    pts = f32_points(3000, 2, 15)
    ref, got = build_fmbi(pts, M), _port_fmbi(pts)
    jdev = JaxTable.from_index(ref)
    tdev = DeviceTable.from_index(got, device="cpu")
    qs = np.random.default_rng(5).random((24, 2)).astype(np.float32)
    ids, d2, ex = knn_query_batch_torch(tdev, qs, 20, fused=False, n_candidate_leaves=1,
                                        max_rounds=0, return_dists=True,
                                        return_exact=True)
    _, jd2, jex = knn_query_batch_jax(jdev, qs, 20, fused=False, n_candidate_leaves=1,
                                      max_rounds=0, return_dists=True,
                                      return_exact=True)
    assert not ex.all() and ex.any()
    np.testing.assert_array_equal(ex, jex)
    full = knn_query_batch_torch(tdev, qs, 20, fused=False, return_dists=True)[1]
    for i in range(len(qs)):
        assert len(ids[i]) == len(d2[i]) == len(jd2[i])
        np.testing.assert_allclose(d2[i], jd2[i], rtol=1e-6, atol=0)
        if ex[i]:
            np.testing.assert_array_equal(d2[i], full[i])
        else:  # the exact k-NN of a candidate subset: never closer
            assert np.all(d2[i] >= full[i][: len(d2[i])])
    with pytest.raises(ValueError):
        knn_query_batch_torch(tdev, qs, 5, fused=False, max_rounds=-1)
    with pytest.raises(ValueError):
        knn_query_batch_torch(tdev, qs, 0, fused=False)
    assert isinstance(knn_query_batch_torch(tdev, qs[:2], 3, fused=False), list)


def test_unfused_multi_chunk_windows_match_one_chunk(monkeypatch):
    pts = f32_points(6000, 2, 13, "skew")
    tdev = DeviceTable.from_index(_port_fmbi(pts), device="cpu")
    c = np.random.default_rng(4).random((40, 2)).astype(np.float32)
    los, his = c - np.float32(0.3), c + np.float32(0.3)
    # window 0 holds every point: a padding pair (window 0, leaf 0) that
    # were not masked would add leaf 0's ids again
    los[0], his[0] = -1, 2
    whole = window_query_batch_torch(tdev, los, his, fused=False)
    sizes = []
    collect = QT._pair_collect

    def counting(dev, qlo, qhi, q_idx, leaf_idx, pair_valid):
        sizes.append(q_idx.shape[0])
        return collect(dev, qlo, qhi, q_idx, leaf_idx, pair_valid)

    monkeypatch.setattr(QT, "PAIR_CHUNK", 16)
    monkeypatch.setattr(QT, "_pair_collect", counting)
    chunked = window_query_batch_torch(tdev, los, his, fused=False)
    assert len(sizes) > 4 and max(sizes) == 16
    hits = QT.frontier_leaf_hits(tdev, torch.from_numpy(los), torch.from_numpy(his))
    assert sum(sizes) > int(hits.sum())   # the last chunk carries padding pairs
    for x, y in zip(whole, chunked):
        np.testing.assert_array_equal(x, y)   # same pair order, same ids
    for i in range(40):
        np.testing.assert_array_equal(np.sort(chunked[i]),
                                      window_oracle(pts, los[i], his[i]))


def test_fused_default_env_pin(monkeypatch):
    monkeypatch.delenv("REPRO_FUSED", raising=False)
    assert QT._fused_default() is True
    monkeypatch.setenv("REPRO_FUSED", "0")
    assert QT._fused_default() is False
    monkeypatch.setenv("REPRO_FUSED", "1")
    assert QT._fused_default() is True
    monkeypatch.setenv("REPRO_FUSED", "")
    assert QT._fused_default() is True


@pytest.mark.parametrize("env", ["0", "1"])
def test_env_pin_selects_the_engine(monkeypatch, env):
    """``REPRO_FUSED`` picks the engine when ``fused`` is not given."""
    pts = f32_points(2000, 2, 14)
    tdev = DeviceTable.from_index(_port_fmbi(pts), device="cpu")
    seen = []
    for name in ("_pair_collect", "_knn_core", "_fused_pack_scan", "_knn_core_fused"):
        orig = getattr(QT, name)
        monkeypatch.setattr(QT, name, lambda *a, _o=orig, _n=name, **kw:
                            seen.append(_n) or _o(*a, **kw))
    monkeypatch.setenv("REPRO_FUSED", env)
    c = np.random.default_rng(3).random((6, 2)).astype(np.float32)
    window_query_batch_torch(tdev, c - np.float32(0.1), c + np.float32(0.1))
    knn_query_batch_torch(tdev, c, 4)
    unfused = {"_pair_collect", "_knn_core"}
    assert set(seen) == (unfused if env == "0" else {"_fused_pack_scan", "_knn_core_fused"})


def test_knn_core_takes_a_leaf_only_table():
    """``_knn_core`` reads only the leaf arrays, so a table without levels
    (the shape a collective round builds per shard) takes a full-budget
    round, as the JAX package's ``_knn_core`` does."""
    pts = f32_points(2500, 2, 31, "grid")
    ref, got = build_fmbi(pts, M), _port_fmbi(pts)
    full = DeviceTable.from_index(got, device="cpu")
    jfull = JaxTable.from_index(ref)
    leaf = DeviceTable(leaf_pts=full.leaf_pts, leaf_ids=full.leaf_ids,
                       leaf_counts=full.leaf_counts, leaf_lo=full.leaf_lo,
                       leaf_hi=full.leaf_hi, levels=(), terminals=(),
                       cold_lo=None, cold_hi=None, n_points=full.n_points)
    jleaf = JaxTable(leaf_pts=jfull.leaf_pts, leaf_ids=jfull.leaf_ids,
                     leaf_counts=jfull.leaf_counts, leaf_lo=jfull.leaf_lo,
                     leaf_hi=jfull.leaf_hi, levels=(), n_points=jfull.n_points)
    qs = _queries(np.random.default_rng(6), 9, 2, "grid")
    ids, d2, exact = QT._knn_core(leaf, torch.from_numpy(qs), 7, leaf.n_leaves)
    _, jd2, jexact = QJ._knn_core(jleaf, qs, 7, jleaf.leaf_pts.shape[0], False)
    assert bool(exact.all()) and bool(np.all(jexact))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2))
    pts32 = pts.astype(np.float32)
    for i in range(len(qs)):
        _check_knn(pts32, qs[i], ids[i].numpy().astype(np.int64), d2[i].numpy(), 7,
                   np.asarray(jd2[i]), True)


def test_host_ids_is_cached_copy_of_leaf_ids():
    tdev = DeviceTable.from_index(_port_fmbi(f32_points(1500, 2, 8)), device="cpu")
    host = tdev.host_ids
    assert isinstance(host, np.ndarray) and host is tdev.host_ids
    np.testing.assert_array_equal(host, tdev.leaf_ids.numpy())


def test_unfused_entry_points_need_cuda_or_cpu(monkeypatch):
    """The export runs on ``cuda`` unless given ``device="cpu"`` and raises
    without a card; on the CPU both first-generation batches launch no
    kernel; on any other device they raise instead of falling back."""
    idx = _port_fmbi(f32_points(1500, 2, 9))
    c = np.random.default_rng(1).random((5, 2)).astype(np.float32)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceTable.from_index(idx)
    dev = DeviceTable.from_index(idx, device="cpu")
    launches.reset()
    window_query_batch_torch(dev, c - np.float32(0.1), c + np.float32(0.1), fused=False)
    knn_query_batch_torch(dev, c, 3, fused=False)
    assert launches.counts() == dict.fromkeys(launches.KERNELS, 0)
    meta = DeviceTable.from_index(idx, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        window_query_batch_torch(meta, c - np.float32(0.1), c + np.float32(0.1),
                                 fused=False)
    with pytest.raises(ValueError, match="no kernel for device"):
        knn_query_batch_torch(meta, c, 3, fused=False)
