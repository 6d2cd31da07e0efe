"""Engine parity: the port's fused window and k-NN batches against the JAX
engine and the NumPy engine (PyTorch port, ``core/queries_torch.py``).

The same numpy inputs go through ``window_query_batch_jax`` /
``knn_query_batch_jax`` (default path: fused, jnp arithmetic on the CPU),
the NumPy ``repro.core.queries`` engine and the port, whose exports live on
the CPU here (``device="cpu"``), where every kernel runs as its plain
version.  Tables come from FMBI (the port's own bulk load) and from the
JAX package's AMBI, grafted on demand and carried across.

Contract:
  * windows: equal id sets, against both engines and a brute force;
  * k-NN: the port's distances equal a float32 brute force computed per
    dimension in the kernels' order, exactly; against the JAX engine they
    are equal on grid data (every sum exact) and within rtol 1e-6 on
    continuous data (XLA's CPU compiler contracts a + b * c into a fused
    multiply-add there); ids must equal the brute force's only where its
    k-th distance is strictly below its (k+1)-th (exact ties may pick
    either point).
"""
import numpy as np
import pytest
import torch

from repro.core import AMBI, knn_query_batch, window_oracle, window_query_batch
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
from repro_torch import tracing
from repro_torch.core import queries_torch as QT

from engines import build_fmbi, build_grafted_ambi, f32_points

M = 120


def _port_fmbi(pts):
    return bulk_load(pts, M, PageStore(M))


def _carried(ref_index, pts):
    cols = {c: getattr(ref_index.table, c) for c in QT.NodeTable.COLUMNS}
    return index_from_arrays(cols, pts, buffer_pages=M)


def _indexes(kind, d, seed, source):
    """(reference index, port index) over the same points: FMBI built on
    each side, or the JAX package's grafted AMBI carried across."""
    pts = f32_points(4000, d, seed, kind)
    if source == "fmbi":
        return pts, build_fmbi(pts, M), _port_fmbi(pts)
    ref = build_grafted_ambi(pts, M)
    return pts, ref, _carried(ref, pts)


def _queries(rng, n, d, kind):
    if kind == "grid":
        return (rng.integers(0, 48, (n, d)) / 64.0).astype(np.float32)
    return rng.random((n, d)).astype(np.float32)


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
    assert len(ids) == m and len(d2) == m
    np.testing.assert_array_equal(d2, full[order[:m]])
    np.testing.assert_array_equal(full[ids], d2)
    if m < len(full) and full[order[m - 1]] < full[order[m]]:
        assert set(ids.tolist()) == set(order[:m].tolist())
    if exact_jax:
        np.testing.assert_array_equal(d2, jax_d2)
    else:
        np.testing.assert_allclose(d2, jax_d2, rtol=1e-6, atol=0)


@pytest.mark.parametrize("source", ["fmbi", "ambi"])
@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("kind", ["uniform", "grid", "skew"])
def test_window_parity(kind, compressed, source):
    pts, ref, got = _indexes(kind, 2, 3, source)
    jdev = JaxTable.from_index(ref, compressed=compressed)
    tdev = DeviceTable.from_index(got, compressed=compressed, device="cpu")
    rng = np.random.default_rng(7)
    c = _queries(rng, 24, 2, kind)
    w = rng.choice([0.01, 0.05, 0.2, 0.6], size=(24, 1)).astype(np.float32)
    los, his = (c - w).astype(np.float32), (c + w).astype(np.float32)
    port = window_query_batch_torch(tdev, los, his)
    jax_res = window_query_batch_jax(jdev, los, his)
    np_res, _ = window_query_batch(ref, los.astype(np.float64), his.astype(np.float64))
    assert len(port) == 24
    for i in range(24):
        got_i = np.sort(port[i])
        assert port[i].dtype == np.int64
        np.testing.assert_array_equal(got_i, np.sort(jax_res[i]))
        np.testing.assert_array_equal(got_i, np.sort(np_res[i]))
        np.testing.assert_array_equal(got_i, window_oracle(pts, los[i], his[i]))


@pytest.mark.parametrize("source", ["fmbi", "ambi"])
@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("kind", ["uniform", "grid", "skew"])
def test_knn_parity(kind, compressed, source):
    d = 3 if kind == "skew" else 2
    pts, ref, got = _indexes(kind, d, 4, source)
    jdev = JaxTable.from_index(ref, compressed=compressed)
    tdev = DeviceTable.from_index(got, compressed=compressed, device="cpu")
    qs = _queries(np.random.default_rng(9), 20, d, kind)
    pts32 = pts.astype(np.float32)
    for k in (1, 7, 40):
        ids, d2 = knn_query_batch_torch(tdev, qs, k, return_dists=True)
        _, jd2 = knn_query_batch_jax(jdev, qs, k, return_dists=True)
        np_ids, _ = knn_query_batch(ref, qs.astype(np.float64), k)
        for i in range(len(qs)):
            _check_knn(pts32, qs[i], ids[i], d2[i], k, jd2[i], kind == "grid")
            np_d2 = np.sort(_brute_d2(pts32, qs[i])[np_ids[i]])
            np.testing.assert_allclose(d2[i], np_d2, rtol=1e-6, atol=0)


def test_kernel_route_parity_small():
    """The JAX engine with its Pallas kernels (interpret mode) against the
    port on one small FMBI table, plain and compressed."""
    pts = f32_points(1500, 2, 21, "grid")
    ref, got = build_fmbi(pts, M), _port_fmbi(pts)
    rng = np.random.default_rng(2)
    c = _queries(rng, 6, 2, "grid")
    los, his = c - np.float32(0.05), c + np.float32(0.05)
    qs = _queries(rng, 6, 2, "grid")
    for compressed in (False, True):
        jdev = JaxTable.from_index(ref, compressed=compressed)
        tdev = DeviceTable.from_index(got, compressed=compressed, device="cpu")
        a = window_query_batch_jax(jdev, los, his, use_kernel=True)
        b = window_query_batch_torch(tdev, los, his)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.sort(x), np.sort(y))
        _, jd2 = knn_query_batch_jax(jdev, qs, 5, use_kernel=True, return_dists=True)
        _, td2 = knn_query_batch_torch(tdev, qs, 5, return_dists=True)
        for x, y in zip(jd2, td2):
            np.testing.assert_array_equal(x, y)


def test_partial_export_return_cold():
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
    assert tdev.live_points() == jdev.live_points() < len(pts)
    c = (rng.random((16, 2)) * 0.4 + 0.3).astype(np.float32)
    los, his = c - np.float32(0.05), c + np.float32(0.05)
    a, a_cold = window_query_batch_jax(jdev, los, his, return_cold=True)
    b, b_cold = window_query_batch_torch(tdev, los, his, return_cold=True)
    assert b_cold.shape == (16, tdev.n_cold) and b_cold.dtype == bool
    np.testing.assert_array_equal(b_cold, a_cold)
    assert b_cold.any() and not b_cold.all()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.sort(x), np.sort(y))
    qs = rng.random((8, 2)).astype(np.float32)
    _, jd2 = knn_query_batch_jax(jdev, qs, 5, return_dists=True)
    _, td2 = knn_query_batch_torch(tdev, qs, 5, return_dists=True)
    for x, y in zip(jd2, td2):
        np.testing.assert_allclose(y, x, rtol=1e-6, atol=0)


def test_all_cold_export_returns_empty():
    pts = f32_points(1000, 2, 6)
    ambi = AMBI(pts, M)
    tdev = DeviceTable.from_table(_carried(ambi.index, pts).table, pts,
                                  partial=True, device="cpu")
    assert tdev.n_leaves == 0 and tdev.n_cold == 1
    res, cold = window_query_batch_torch(tdev, [[0.1, 0.1]], [[0.4, 0.4]],
                                         return_cold=True)
    assert len(res[0]) == 0 and cold.tolist() == [[True]]
    ids, d2, exact = knn_query_batch_torch(tdev, [[0.5, 0.5]], 3,
                                           return_dists=True, return_exact=True)
    assert len(ids[0]) == 0 and len(d2[0]) == 0 and exact.tolist() == [True]


def test_multi_chunk_windows_match_one_chunk(monkeypatch):
    pts = f32_points(6000, 2, 13, "skew")
    tdev = DeviceTable.from_index(_port_fmbi(pts), device="cpu")
    rng = np.random.default_rng(4)
    c = rng.random((40, 2)).astype(np.float32)
    los, his = c - np.float32(0.3), c + np.float32(0.3)
    whole = window_query_batch_torch(tdev, los, his)
    calls = []
    scan = QT._fused_pack_scan

    def counting(*a, **kw):
        calls.append(a[5])
        return scan(*a, **kw)

    monkeypatch.setattr(QT, "PAIR_CHUNK", 16)
    monkeypatch.setattr(QT, "_fused_pack_scan", counting)
    chunked = window_query_batch_torch(tdev, los, his)
    assert len(calls) > 4 and max(calls) == 16
    for x, y in zip(whole, chunked):
        np.testing.assert_array_equal(x, y)   # same pair order, same ids
    for i in range(40):
        np.testing.assert_array_equal(np.sort(chunked[i]),
                                      window_oracle(pts, los[i], his[i]))


@pytest.mark.parametrize("chunk", [None, 16])
def test_window_answers_are_views_of_one_int64_buffer(chunk, monkeypatch):
    pts = f32_points(6000, 2, 13, "skew")
    tdev = DeviceTable.from_index(_port_fmbi(pts), device="cpu")
    rng = np.random.default_rng(9)
    c = rng.random((40, 2)).astype(np.float32)
    w = rng.choice([0.0, 0.02, 0.3], size=(40, 1)).astype(np.float32)
    los, his = c - w, c + w
    los[::7], his[::7] = 2.0, 3.0     # empty windows between the others
    packed, pack = [], QT._fused_id_pack

    def keeping(*a):
        packed.append(pack(*a))
        return packed[-1]

    if chunk:
        monkeypatch.setattr(QT, "PAIR_CHUNK", chunk)
    monkeypatch.setattr(QT, "_fused_id_pack", keeping)
    before = tracing.counters()
    res = window_query_batch_torch(tdev, los, his)
    after = tracing.counters()
    assert len(packed) > (4 if chunk else 0)
    # one int64 buffer, partitioned in window order: each answer starts
    # where the one before it ends, and together they are the packed ids
    assert all(r.dtype == np.int64 and r.base is res[0].base for r in res)
    at = res[0].base.__array_interface__["data"][0]
    before_ids = np.cumsum([0] + [len(r) for r in res[:-1]])
    assert all(r.__array_interface__["data"][0] == at + 8 * int(b)
               for r, b in zip(res, before_ids) if len(r))
    np.testing.assert_array_equal(np.concatenate(res), torch.cat(packed).numpy())
    assert all(len(res[i]) == 0 for i in range(0, 40, 7))
    unfused = window_query_batch_torch(tdev, los, his, fused=False)
    for i in range(40):
        np.testing.assert_array_equal(np.sort(res[i]), np.sort(unfused[i]))
        np.testing.assert_array_equal(np.sort(res[i]), window_oracle(pts, los[i], his[i]))
    # a CPU export hands off in pageable memory
    for name in ("engine.answers_pinned", "engine.answers_fresh_blocks"):
        assert after[name] == before.get(name, 0)


def test_empty_window_results():
    pts = f32_points(2000, 2, 14)
    tdev = DeviceTable.from_index(_port_fmbi(pts), device="cpu")
    los = np.full((5, 2), 2.0, np.float32)
    res = window_query_batch_torch(tdev, los, los + 1)
    assert len(res) == 5 and all(len(r) == 0 and r.dtype == np.int64 for r in res)
    # one window hits, the rest do not: the split keeps empty neighbours
    los[2] = [0.2, 0.2]
    res = window_query_batch_torch(tdev, los, los + np.float32(0.1))
    assert [len(r) > 0 for r in res] == [False, False, True, False, False]
    np.testing.assert_array_equal(np.sort(res[2]), window_oracle(pts, los[2], los[2] + np.float32(0.1)))


def test_knn_options():
    pts = f32_points(4000, 2, 15)
    ref, got = build_fmbi(pts, M), _port_fmbi(pts)
    jdev = JaxTable.from_index(ref)
    tdev = DeviceTable.from_index(got, device="cpu")
    qs = np.random.default_rng(5).random((30, 2)).astype(np.float32)
    pts32 = pts.astype(np.float32)
    # k >= n: every point, in distance order
    small = f32_points(200, 2, 16)
    sdev = DeviceTable.from_index(_port_fmbi(small), device="cpu")
    ids, d2 = knn_query_batch_torch(sdev, qs[:3], 500, return_dists=True)
    for i in range(3):
        assert len(ids[i]) == 200 and sorted(ids[i].tolist()) == list(range(200))
        np.testing.assert_array_equal(d2[i], np.sort(_brute_d2(small.astype(np.float32), qs[i])))
    # a budget of one leaf escalates on the device until certified
    ids, d2, exact = knn_query_batch_torch(tdev, qs, 20, n_candidate_leaves=1,
                                           return_dists=True, return_exact=True)
    assert exact.all()
    _, jd2 = knn_query_batch_jax(jdev, qs, 20, n_candidate_leaves=1, return_dists=True)
    for i in range(30):
        _check_knn(pts32, qs[i], ids[i], d2[i], 20, jd2[i], False)
    # max_rounds=0: best-effort answers, labelled
    ids0, d20, ex0 = knn_query_batch_torch(tdev, qs, 20, n_candidate_leaves=1,
                                           max_rounds=0, return_dists=True,
                                           return_exact=True)
    _, jd20, jex0 = knn_query_batch_jax(jdev, qs, 20, n_candidate_leaves=1,
                                        max_rounds=0, return_dists=True,
                                        return_exact=True)
    assert not ex0.all()
    np.testing.assert_array_equal(ex0, jex0)
    for i in range(30):
        assert len(ids0[i]) == 20
        if ex0[i]:
            np.testing.assert_array_equal(d20[i], d2[i])
        else:  # the exact k-NN of a candidate subset: never closer
            assert np.all(d20[i] >= d2[i])
        np.testing.assert_allclose(d20[i], jd20[i], rtol=1e-6, atol=0)
    with pytest.raises(ValueError):
        knn_query_batch_torch(tdev, qs, 5, max_rounds=-1)
    with pytest.raises(ValueError):
        knn_query_batch_torch(tdev, qs, 0)
    with pytest.raises(ValueError, match="queries must be"):
        knn_query_batch_torch(tdev, np.zeros((4, 3)), 5)
    with pytest.raises(ValueError, match="windows must be"):
        window_query_batch_torch(tdev, np.zeros((4, 2)), np.ones((3, 2)))
    only_ids = knn_query_batch_torch(tdev, qs[:2], 3)
    assert isinstance(only_ids, list) and only_ids[0].dtype == np.int64


def test_compressed_matches_plain_export():
    pts = f32_points(5000, 3, 17, "skew")
    got = _port_fmbi(pts)
    plain = DeviceTable.from_index(got, device="cpu")
    comp = DeviceTable.from_index(got, compressed=True, device="cpu")
    rng = np.random.default_rng(8)
    c = rng.random((32, 3)).astype(np.float32) ** 3
    los, his = c - np.float32(0.02), c + np.float32(0.02)
    hits_p, n_p = QT._frontier_count(plain, torch.from_numpy(los), torch.from_numpy(his))
    hits_c, n_c = QT._frontier_count(comp, torch.from_numpy(los), torch.from_numpy(his))
    assert bool((hits_c | ~hits_p).all()) and int(n_c) >= int(n_p)  # superset
    for x, y in zip(window_query_batch_torch(plain, los, his),
                    window_query_batch_torch(comp, los, his)):
        np.testing.assert_array_equal(np.sort(x), np.sort(y))
    for x, y in zip(knn_query_batch_torch(plain, los, 9),
                    knn_query_batch_torch(comp, los, 9)):
        np.testing.assert_array_equal(np.sort(x), np.sort(y))
