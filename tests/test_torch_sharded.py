"""Sharded engine of the PyTorch port against the JAX package's:
``ShardedDeviceTable``, the router fan-out of windows, the two-round
certified k-NN protocol, and the host layer of parallel bulk loading.

The reference's scenarios (``tests/test_distributed_jax.py``) run through
``repro.core.distributed_jax`` (JAX on the CPU) and through the port's
``core/distributed_torch.py`` with ``device="cpu"``, where every kernel
runs as its plain version, beside the port's NumPy engine as the oracle.
Points are float32-representable (``engines.f32_points``).  Contract:

  * windows: equal id sets in every engine, equal to the NumPy oracle;
  * k-NN: equal f64 distance sequences, equal to a brute force, and equal
    ids where the oracle's k-th distance is strictly below its (k+1)-th.
    XLA's CPU compiler contracts ``acc + g*g`` into an FMA and the port
    rounds each operation, so a shard's k-th f32 distance may differ by an
    ulp off grid data, and round 2 may then probe other (query, shard)
    pairs: probe sets are compared only on grid data (``"grid"``), where
    every distance is exact;
  * equal shard plans, router boxes, ``stacked()`` layouts and
    ``parallel_bulk_load`` results (IOStats, ``row_maps``, every column
    of ``merged_table``).
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import AMBI as RefAMBI
from repro.core import distributed_jax as DJ
from repro.core.distributed import parallel_bulk_load as ref_parallel_bulk_load
from repro.core.distributed import parallel_window_cost as ref_parallel_window_cost
from repro_torch.core import AMBI, DeviceTable, NodeTable, PageStore, bulk_load
from repro_torch.core import distributed_torch as DT
from repro_torch.core import knn_query_batch_torch, window_query_batch_torch
from repro_torch.core.distributed import parallel_bulk_load, parallel_window_cost
from repro_torch.core.distributed_torch import (
    ShardedDeviceTable,
    ShardUnavailable,
    knn_query_batch_sharded,
    window_query_batch_sharded,
)
from repro_torch.core.geometry import boxes_intersect_windows
from repro_torch.core.queries import knn_query_batch, window_oracle, window_query_batch

from engines import (
    assert_degraded_knn,
    assert_degraded_window,
    build_fmbi,
    build_grafted_ambi,
    f32_points,
    shard_owned_ids,
)

CPU = "cpu"
MS = (1, 2, 4)


def _windows(rng, d, n, width):
    centers = rng.random((n, d)).astype(np.float32).astype(np.float64)
    return centers - width, centers + width, centers


def _port_grafted_ambi(pts, M=250):
    """``engines.build_grafted_ambi`` on the port's AMBI."""
    ambi = AMBI(pts, M)
    d = pts.shape[1]
    rng = np.random.default_rng(0)
    for _ in range(4):
        c = rng.random(d)
        ambi.window(c - 0.05, c + 0.05)
    ambi.window(np.zeros(d), np.ones(d))
    assert ambi.is_fully_refined()
    return ambi.index


def _same_table(a, b):
    assert a.n_nodes == b.n_nodes
    for c in NodeTable.COLUMNS:
        assert np.array_equal(getattr(a, c), getattr(b, c)), c


class Suite:
    """The port's NumPy engine (the oracle), the reference's sharded
    engine and the port's, fused and first generation, for each m, over
    one pair of equal indexes."""

    def __init__(self, ref_index, port_index, ms=MS):
        _same_table(ref_index.table, port_index.table)
        self.pts = port_index.points
        self.oracle = port_index
        self.ref = {m: DJ.ShardedDeviceTable.from_index(ref_index, m) for m in ms}
        self.port = {m: ShardedDeviceTable.from_index(port_index, m, device=CPU)
                     for m in ms}
        for m in ms:
            r, p = self.ref[m], self.port[m]
            assert p.m == r.m and p.shard_roots == r.shard_roots
            assert np.array_equal(p.shard_lo, r.shard_lo)
            assert np.array_equal(p.shard_hi, r.shard_hi)
            assert p.n_points == r.n_points

    def engines(self):
        for m in self.ref:
            yield f"ref[m={m}]", self.ref[m], DJ, {}
            for fused in (True, False):
                yield f"port[m={m},fused={fused}]", self.port[m], DT, {"fused": fused}

    def windows(self, los, his):
        want = window_query_batch(self.oracle, los, his)[0]
        for name, sdev, mod, kw in self.engines():
            got = mod.window_query_batch_sharded(sdev, los, his, **kw)
            assert len(got) == len(want), name
            for i, (g, w) in enumerate(zip(got, want)):
                assert np.array_equal(np.sort(g), np.sort(w)), (name, i)
                assert np.array_equal(np.sort(g), window_oracle(self.pts, los[i], his[i]))
        return want

    def knn(self, qs, k):
        want = knn_query_batch(self.oracle, qs, k)[0]
        for name, sdev, mod, kw in self.engines():
            got = mod.knn_query_batch_sharded(sdev, qs, k, **kw)
            assert len(got) == len(want), name
            for i, (g, w) in enumerate(zip(got, want)):
                check_knn(self.pts, qs[i], k, g, w, name)
        return want


def check_knn(pts, q, k, got, want, what=""):
    """The port's k-NN contract: equal f64 distance sequences, equal to
    the brute force; equal ids where the k-th distance is unique."""
    dg = np.sum((pts[got] - q) ** 2, axis=1)
    dw = np.sum((pts[want] - q) ** 2, axis=1)
    assert np.array_equal(dg, dw), what
    full = np.sort(np.sum((pts - q) ** 2, axis=1))
    assert len(got) == min(k, len(pts)), what
    assert np.array_equal(np.sort(dg), full[: len(dg)]), what
    assert len(set(got.tolist())) == len(got), what
    if len(full) > k and full[k - 1] < full[k]:
        assert set(got.tolist()) == set(want.tolist()), what


def _pair(pts, M=250):
    return build_fmbi(pts, M), bulk_load(pts, M, PageStore(M))


# --------------------------------------------------------------------------
# parity: the oracle, the reference's engine and the port's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind,d,seed", [
    ("uniform", 2, 0), ("uniform", 3, 1), ("skew", 2, 2),
])
def test_parity_fmbi(kind, d, seed):
    pts = f32_points(6000, d, seed, kind)
    suite = Suite(*_pair(pts))
    los, his, centers = _windows(np.random.default_rng(seed + 50), d, 16, 0.06)
    suite.windows(los, his)
    suite.knn(centers, 10)


def test_parity_grafted_ambi():
    pts = f32_points(8000, 2, 7, "skew")
    suite = Suite(build_grafted_ambi(pts), _port_grafted_ambi(pts))
    los, his, centers = _windows(np.random.default_rng(8), 2, 16, 0.05)
    suite.windows(los, his)
    suite.knn(centers, 8)


def _spy(monkeypatch, mod, fn_name, sdev):
    """Record ``(shard, queries)`` of every per-shard dispatch."""
    calls = []
    real = getattr(mod, fn_name)
    index = {id(dev): s for s, dev in enumerate(sdev.shards)}

    def spy(dev, qs, *a, **kw):
        calls.append((index[id(dev)], len(np.atleast_2d(qs))))
        return real(dev, qs, *a, **kw)

    monkeypatch.setattr(mod, fn_name, spy)
    return calls


@pytest.mark.parametrize("m", [2, 4])
def test_duplicate_coordinates_probe_the_reference_shards(m, monkeypatch):
    """Grid data: coincident points and exact ties, every f32 distance
    exact in both packages.  Distances agree everywhere; the k-NN rounds
    probe the same (shard, query count) pairs as the reference's, and the
    windows dispatch to the same shards."""
    pts = f32_points(5000, 2, 9, "grid")
    suite = Suite(*_pair(pts), ms=(m,))
    rng = np.random.default_rng(10)
    qs = (rng.integers(0, 48, (8, 2)) / 64.0).astype(np.float64)
    los, his = qs - 3 / 64.0, qs + 3 / 64.0
    suite.windows(los, his)
    suite.knn(qs, 16)
    r, p = suite.ref[m], suite.port[m]
    calls = {}
    for kind, call in (("window", lambda s, mod, **kw: mod.window_query_batch_sharded(
                            s, los, his, **kw)),
                       ("knn", lambda s, mod, **kw: mod.knn_query_batch_sharded(
                            s, qs, 16, **kw))):
        fn = {"window": ("window_query_batch_jax", "window_query_batch_torch"),
              "knn": ("knn_query_batch_jax", "knn_query_batch_torch")}[kind]
        ref_calls = _spy(monkeypatch, DJ, fn[0], r)
        call(r, DJ)
        for fused in (True, False):
            port_calls = _spy(monkeypatch, DT, fn[1], p)
            call(p, DT, fused=fused)
            assert port_calls == ref_calls, (kind, fused)
        calls[kind] = ref_calls
    assert calls["window"] and len(calls["knn"]) > 1


# --------------------------------------------------------------------------
# edge cases
# --------------------------------------------------------------------------
@pytest.mark.parametrize("fused", [True, False])
def test_m1_identical_to_single_table_engine(fused):
    pts = f32_points(4000, 2, 3)
    idx = bulk_load(pts, 250, PageStore(250))
    sdev = ShardedDeviceTable.from_index(idx, 1, device=CPU)
    assert sdev.m == 1 and sdev.shard_roots == [[0]]
    dev = DeviceTable.from_index(idx, device=CPU)
    los, his, centers = _windows(np.random.default_rng(4), 2, 8, 0.08)
    for a, b in zip(window_query_batch_sharded(sdev, los, his, fused=fused),
                    window_query_batch_torch(dev, los, his, fused=fused)):
        assert np.array_equal(np.sort(a), np.sort(b))
    for a, b in zip(knn_query_batch_sharded(sdev, centers, 7, fused=fused),
                    knn_query_batch_torch(dev, centers, 7, fused=fused)):
        assert np.array_equal(a, b)


def test_window_fans_out_only_to_qualified_shards(monkeypatch):
    """A shard whose subspace MBB misses every query box receives no
    dispatch at all, in both packages alike."""
    pts = f32_points(6000, 2, 11)
    ref_idx, idx = _pair(pts)
    sdev = ShardedDeviceTable.from_index(idx, 4, device=CPU)
    rdev = DJ.ShardedDeviceTable.from_index(ref_idx, 4)
    los = np.tile(sdev.shard_lo[0].astype(np.float64), (3, 1))
    his = los + 1e-4
    hit = boxes_intersect_windows(sdev.shard_lo, sdev.shard_hi,
                                  los.astype(np.float32), his.astype(np.float32))
    assert not hit.all(), "boxes must miss at least one shard"
    ref_calls = _spy(monkeypatch, DJ, "window_query_batch_jax", rdev)
    port_calls = _spy(monkeypatch, DT, "window_query_batch_torch", sdev)
    want = DJ.window_query_batch_sharded(rdev, los, his)
    got = window_query_batch_sharded(sdev, los, his)
    assert port_calls == ref_calls
    assert {s for s, _ in port_calls} == {s for s in range(4) if hit[:, s].any()}
    for i in range(3):
        assert np.array_equal(np.sort(got[i]), window_oracle(pts, los[i], his[i]))
        assert np.array_equal(np.sort(got[i]), np.sort(want[i]))


def test_windows_entirely_outside_all_shards(monkeypatch):
    pts = f32_points(3000, 2, 15)
    sdev = ShardedDeviceTable.from_index(bulk_load(pts, 250, PageStore(250)), 4,
                                         device=CPU)
    calls = _spy(monkeypatch, DT, "window_query_batch_torch", sdev)
    los = np.full((3, 2), 2.0)
    got = window_query_batch_sharded(sdev, los, los + 0.1)
    assert all(len(g) == 0 for g in got) and calls == []


def test_k_geq_points_per_shard():
    """k larger than any single shard forces the +inf pruning radius and
    full escalation; the answers are still the exact global top-k."""
    pts = f32_points(2000, 2, 5)
    suite = Suite(*_pair(pts), ms=(2, 4))
    qs = np.random.default_rng(6).random((4, 2)).astype(np.float32).astype(np.float64)
    for k in (600, 1200, 2500):  # > n/4, > n/2, > n
        want = suite.knn(qs, k)
        assert all(len(w) == min(k, len(pts)) for w in want)


def test_queries_straddling_shard_boundaries():
    pts = f32_points(6000, 2, 12)
    suite = Suite(*_pair(pts))
    center = np.float64(np.float32(0.5))
    los = np.array([[center - 0.4, center - 0.4], [0.0, center - 0.01],
                    [center - 0.01, 0.0]])
    his = np.array([[center + 0.4, center + 0.4], [1.0, center + 0.01],
                    [center + 0.01, 1.0]])
    suite.windows(los, his)
    suite.knn(np.array([[center, center], [center, 0.1], [0.9, center]]), 24)
    for m in (2, 4):
        sdev = suite.port[m]
        hit = boxes_intersect_windows(sdev.shard_lo, sdev.shard_hi,
                                      los.astype(np.float32), his.astype(np.float32))
        assert hit[0].sum() > 1


# --------------------------------------------------------------------------
# C.1's overflowing queries and the NaN query through the protocol
# --------------------------------------------------------------------------
M_EDGE = 120
SCALE = 2.0**60


def _edge_setup(scale):
    pts = f32_points(4000, 2, 1) * scale
    idx = bulk_load(pts, M_EDGE, PageStore(M_EDGE))
    return pts, idx, DeviceTable.from_index(idx, device=CPU)


def _f32_d2(pts32, q):
    acc = np.zeros(len(pts32), dtype=np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        for j in range(pts32.shape[1]):
            diff = pts32[:, j] - q[j]
            acc = acc + diff * diff
    return acc


@pytest.mark.parametrize("case,scale,q,k", [
    ("overflow", 1.0, [2e19, 0.5], 3),
    ("inf_coordinate", 1.0, [np.inf, 0.5], 3),
    ("padding_escalates", SCALE, [SCALE + 1.3e19] * 2, 300),
])
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("fused", [True, False])
def test_overflowing_queries_answer_live_rows(case, scale, q, k, m, fused):
    """Every live distance (or all but a few) overflows f32: the protocol
    answers as the single-table port does, k distinct dataset rows with
    the brute force's distances (ids may differ among the +inf ties).  A
    shard's answer is trimmed to its live points, so no padding reaches the
    cross-shard merge, which ranks raw f32 distances."""
    pts, idx, single = _edge_setup(scale)
    sdev = ShardedDeviceTable.from_index(idx, m, device=CPU)
    qs = np.array([q], dtype=np.float32)
    seen = []
    real = DT.knn_query_batch_torch

    def spy(dev, *a, **kw):
        out = real(dev, *a, **kw)
        seen.extend(out[0])
        return out

    DT.knn_query_batch_torch = spy
    try:
        with np.errstate(invalid="ignore"):
            got = knn_query_batch_sharded(sdev, qs, k, fused=fused)[0]
    finally:
        DT.knn_query_batch_torch = real
    assert all((ids >= 0).all() for ids in seen)   # no padding from any shard
    one, d_one = knn_query_batch_torch(single, qs, k, fused=fused, return_dists=True)
    full = _f32_d2(pts.astype(np.float32), qs[0])
    assert len(got) == k and (got >= 0).all() and len(set(got.tolist())) == k
    np.testing.assert_array_equal(full[got], np.sort(full, kind="stable")[:k])
    np.testing.assert_array_equal(full[got], d_one[0])
    finite = np.isfinite(full[got])
    np.testing.assert_array_equal(got[finite], one[0][finite])


@pytest.mark.parametrize("m", [2, 4])
def test_nan_query_answers_from_its_home_shard(m):
    """A NaN query (``DeviceQueryServer`` rejects it) has NaN router
    mindists: round 1 sends it to shard 0, round 2 escalates nothing, and
    the answer is shard 0's own, its NaN-distance rows where the single
    table answers padding (ROADMAP C.2).  The reference's protocol routes
    it the same way."""
    pts, idx, single = _edge_setup(1.0)
    sdev = ShardedDeviceTable.from_index(idx, m, device=CPU)
    qs = np.array([[np.nan, 0.5]], dtype=np.float32)
    with np.errstate(invalid="ignore"):
        got = knn_query_batch_sharded(sdev, qs, 3)[0]
        home = knn_query_batch_torch(sdev.shards[0], qs, 3)[0]
    np.testing.assert_array_equal(got, home)
    np.testing.assert_array_equal(knn_query_batch_torch(single, qs, 3)[0], [-1, -1, -1])


# --------------------------------------------------------------------------
# hypothesis: randomized workloads on grid data (exact f32)
# --------------------------------------------------------------------------
_CACHE = {}


def _cached(seed):
    if seed not in _CACHE:
        pts = f32_points(4000, 2, seed, "grid")
        _CACHE[seed] = Suite(*_pair(pts), ms=(2, 4))
    return _CACHE[seed]


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 1), qseed=st.integers(0, 10_000),
       w=st.integers(1, 12), k=st.integers(1, 24))
def test_hypothesis_parity(seed, qseed, w, k):
    """The reference's property test with the port's k-NN check (equal
    distance sequences; ids only where the k-th distance is unique), not
    the reference's ``_knn_check`` (ROADMAP C.3)."""
    suite = _cached(seed)
    rng = np.random.default_rng(qseed)
    centers = rng.integers(0, 48, (5, 2)) / 64.0
    suite.windows(centers - w / 64.0, centers + w / 64.0)
    suite.knn(centers, k)


# --------------------------------------------------------------------------
# the host m-server build and the sharded device engine
# --------------------------------------------------------------------------
@pytest.mark.parametrize("m", [1, 4])
def test_parallel_bulk_load_equals_the_reference(m):
    pts = f32_points(20_000, 2, 31)
    ref = ref_parallel_bulk_load(pts, m=m, buffer_pages=600,
                                 rng=np.random.default_rng(5))
    got = parallel_bulk_load(pts, m=m, buffer_pages=600, rng=np.random.default_rng(5))
    assert vars(got.central_io) == vars(ref.central_io)
    assert [vars(s) for s in got.per_server_io] == [vars(s) for s in ref.per_server_io]
    assert got.makespan_io == ref.makespan_io and got.total_io == ref.total_io
    assert len(got.row_maps) == len(ref.row_maps) == m
    for a, b in zip(got.row_maps, ref.row_maps):
        assert np.array_equal(a, b)
    _same_table(ref.merged_table(), got.merged_table())
    merged = got.merged_index(pts, 600)
    assert merged.store.allocated_pages == ref.merged_index(pts, 600).store.allocated_pages
    rng = np.random.default_rng(3)
    for _ in range(3):
        c = rng.random(2)
        lo, hi = c - 0.05, c + 0.05
        assert parallel_window_cost(got, lo, hi) == ref_parallel_window_cost(ref, lo, hi)


def test_from_parallel_build_serves_globally():
    """The m-server simulation ships into the sharded engine (per-server
    subtrees become the shards verbatim), with the reference's router."""
    pts = f32_points(20_000, 2, 31)
    build = parallel_bulk_load(pts, m=4, buffer_pages=600)
    sdev = ShardedDeviceTable.from_parallel_build(build, pts, device=CPU)
    rdev = DJ.ShardedDeviceTable.from_parallel_build(
        ref_parallel_bulk_load(pts, m=4, buffer_pages=600), pts)
    assert sdev.m == 4 and sdev.n_points == len(pts) == rdev.n_points
    assert np.array_equal(sdev.shard_lo, rdev.shard_lo)
    assert np.array_equal(sdev.shard_hi, rdev.shard_hi)
    los, his, centers = _windows(np.random.default_rng(3), 2, 8, 0.04)
    got = window_query_batch_sharded(sdev, los, his)
    for i in range(8):
        assert np.array_equal(np.sort(got[i]), window_oracle(pts, los[i], his[i]))
    gotk = knn_query_batch_sharded(sdev, centers, 12)
    wantk = DJ.knn_query_batch_sharded(rdev, centers, 12)
    for i in range(8):
        d2 = np.sum((pts - centers[i]) ** 2, axis=1)
        np.testing.assert_array_equal(np.sort(d2[gotk[i]]), np.sort(d2)[:12])
        check_knn(pts, centers[i], 12, gotk[i], wantk[i])


@pytest.mark.parametrize("m", [2, 4])
def test_stacked_equals_the_reference(m):
    pts = f32_points(6000, 2, 13)
    ref_idx, idx = _pair(pts)
    want = DJ.ShardedDeviceTable.from_index(ref_idx, m).stacked()
    got = ShardedDeviceTable.from_index(idx, m, device=CPU).stacked()
    assert got.keys() == want.keys()
    for key in want:
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), key
        if key != "n_points":
            assert got[key].dtype == want[key].dtype, key


def test_stacked_needs_refined_shards():
    pts = f32_points(20_000, 2, 14)
    ambi = AMBI(pts, 100)   # one unrefined root: a cold row, no leaf
    sdev = ShardedDeviceTable.from_table(ambi.table, pts, 2, partial=True, device=CPU)
    assert sdev.m == 1 and sdev.shards[0].n_cold == 1
    with pytest.raises(ValueError, match="fully refined"):
        sdev.stacked()


def test_refresh_scaffolding_equals_the_reference():
    """``shards_of_rows``, ``refresh`` and ``remap_source_rows`` on a
    grafting AMBI table, step for step beside the reference's: equal plans,
    owners, routers, shard exports and upload counts."""
    from repro.core.queries_jax import UploadStats as RefUploadStats
    from repro_torch.core import UploadStats

    pts = f32_points(60_000, 2, 10)
    ref_ambi, ambi = RefAMBI(pts, 120), AMBI(pts, 120)
    for a in (ref_ambi, ambi):
        a.window(np.full(2, 0.4), np.full(2, 0.45))
    ref_st, st_ = RefUploadStats(), UploadStats()
    r = DJ.ShardedDeviceTable.from_table(ref_ambi.table, pts, 4, partial=True, stats=ref_st)
    p = ShardedDeviceTable.from_table(ambi.table, pts, 4, partial=True, stats=st_,
                                      device=CPU)
    assert p.shard_roots == r.shard_roots and p.m == r.m == 4
    rng = np.random.default_rng(11)
    for _ in range(3):
        c = rng.random(2) * 0.3 + 0.3
        for a in (ref_ambi, ambi):
            before = np.flatnonzero(a.table.unrefined)
            a.window(c - 0.02, c + 0.02)
        grafted = before[~ambi.table.unrefined[before]]
        owners = p.shards_of_rows(grafted)
        assert owners == r.shards_of_rows(grafted) and owners
        r.refresh(owners)
        p.refresh(owners)
        assert np.array_equal(p.shard_lo, r.shard_lo) and p.n_points == r.n_points
        for s in range(4):
            assert np.array_equal(p.shards[s].host_ids, np.asarray(r.shards[s].leaf_ids))
            assert p.shards[s].n_cold == r.shards[s].n_cold
    assert st_.as_dict() == ref_st.as_dict()
    remap = ambi.table.compact()
    assert np.array_equal(remap, ref_ambi.table.compact())
    r.remap_source_rows(remap)
    p.remap_source_rows(remap)
    assert p.shard_roots == r.shard_roots
    with pytest.raises(ValueError, match="no shard plan"):
        ShardedDeviceTable.from_tables([ambi.table], pts, partial=True,
                                       device=CPU).shards_of_rows([0])


# --------------------------------------------------------------------------
# degraded protocol (the unit under the serving tests)
# --------------------------------------------------------------------------
def test_protocol_level_degraded_queries():
    """With a runner that kills shard 1, the protocols raise without
    certificates and, with them, answer exactly what the alive shards
    hold; certificates equal the reference protocol's."""
    pts = f32_points(900, 2, seed=21)
    ref_idx, idx = _pair(pts, M=64)
    sdev = ShardedDeviceTable.from_index(idx, 4, device=CPU)
    rdev = DJ.ShardedDeviceTable.from_index(ref_idx, 4)
    dead = 1
    owned = shard_owned_ids(sdev, dead)
    assert owned == shard_owned_ids(rdev, dead)
    rng = np.random.default_rng(4)
    c = rng.random((16, 2))
    los, his = np.clip(c - 0.15, 0, 1), np.clip(c + 0.15, 0, 1)
    qs = rng.random((16, 2))

    def runner(exc):
        def run(s, thunk):
            if s == dead:
                raise exc(s, "injected")
            return thunk()
        return run

    with pytest.raises(ShardUnavailable):
        window_query_batch_sharded(sdev, los, his, runner=runner(ShardUnavailable))
    healthy = window_query_batch_sharded(sdev, los, his)
    got, certs = window_query_batch_sharded(sdev, los, his, runner=runner(ShardUnavailable),
                                            return_certs=True)
    _, rcerts = DJ.window_query_batch_sharded(rdev, los, his,
                                              runner=runner(DJ.ShardUnavailable),
                                              return_certs=True)
    for i in range(len(los)):
        assert_degraded_window(pts, los[i], his[i], got[i], certs[i], healthy[i], owned)
    healthy_k = knn_query_batch_sharded(sdev, qs, 5)
    gotk, kcerts = knn_query_batch_sharded(sdev, qs, 5, runner=runner(ShardUnavailable),
                                           return_certs=True)
    _, rkcerts = DJ.knn_query_batch_sharded(rdev, qs, 5,
                                            runner=runner(DJ.ShardUnavailable),
                                            return_certs=True)
    for i in range(len(qs)):
        assert_degraded_knn(pts, qs[i], 5, gotk[i], kcerts[i], healthy_k[i], owned)
    for a, b in zip(certs + kcerts, rcerts + rkcerts):
        assert (a.complete, a.certified_exact, a.missing_shards) == (
            b.complete, b.certified_exact, b.missing_shards)
        for x, y in ((a.missing_lo, b.missing_lo), (a.missing_hi, b.missing_hi)):
            assert (x is None and y is None) or np.array_equal(x, y)
    assert any(not c.complete for c in certs)
    assert any(c.certified_exact and not c.complete for c in kcerts)
