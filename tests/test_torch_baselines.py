"""The paper's competitor loaders and the Table-1 leaf metrics in the port
(``core/baselines.py``, ``core/hilbert.py``, ``core/metrics.py``) against
the JAX package's, and the port's device engine over each loader's tree.

Both packages build all six ``ALL_LOADERS`` trees over the same points at
``tests/test_baselines.py``'s sizes (N = 250,000, a buffer of M = 250
pages: the buffer spills).  Contract:

  * ``tests/test_baselines.py``'s scenarios on the port's trees: every
    point indexed once, window answers equal to the oracle, packed
    loaders full, KDB leaves not packed, the construction-cost ordering
    and FMBI's competitive leaf area;
  * per loader: the ten ``NodeTable`` columns, IOStats, ``leaf_stats``
    and ``overlap_area_2d`` equal to the reference's;
  * per loader: the port's ``DeviceTable`` on the CPU answers windows with
    the id sets of ``queries_jax`` (and the oracle), and k-NN with its
    distance sequences at rtol 1e-6 (XLA's CPU compiler contracts into
    FMAs; ROADMAP C.2), equal to a float32 brute force.
"""
import numpy as np
import pytest

from repro.core import ALL_LOADERS as REF_LOADERS
from repro.core import PageStore as RefPageStore
from repro.core import metrics as ref_metrics
from repro.core.queries_jax import DeviceTable as JaxTable
from repro.core.queries_jax import knn_query_batch_jax, window_query_batch_jax
from repro_torch.core import (
    ALL_LOADERS,
    DeviceTable,
    NodeTable,
    PageStore,
    knn_query_batch_torch,
    leaf_stats,
    overlap_area_2d,
    window_oracle,
    window_query,
    window_query_batch_torch,
)
from repro_torch.core.datasets import osm_like

N = 250_000  # 734 pages >> M: the buffer must spill
M = 250
NAMES = sorted(ALL_LOADERS)
K = 16


@pytest.fixture(scope="module")
def data():
    # f32-representable, as the card holds them: one oracle for both engines
    return osm_like(N, seed=21).astype(np.float32).astype(np.float64)


@pytest.fixture(scope="module")
def built(data):
    """Per loader: (port index, its build IOStats, reference index, its
    build IOStats); the stats are copied before any query charges reads."""
    out = {}
    for name in NAMES:
        store, ref_store = PageStore(M), RefPageStore(M)
        idx = ALL_LOADERS[name](data, M, store)
        ref = REF_LOADERS[name](data, M, ref_store)
        out[name] = (idx, _io(store.stats), ref, _io(ref_store.stats))
    return out


def _io(stats):
    return {"reads": stats.reads, "writes": stats.writes, "total": stats.total}


def test_port_has_the_reference_loaders():
    assert sorted(REF_LOADERS) == NAMES == ["fmbi", "hilbert", "kdb", "omt", "str", "waffle"]


@pytest.mark.parametrize("name", NAMES)
def test_loader_indexes_every_point(built, data, name):
    idx = built[name][0]
    rows = np.concatenate([leaf.point_idx for leaf in idx.root.iter_leaves()])
    assert len(rows) == len(data) and len(np.unique(rows)) == len(data)


@pytest.mark.parametrize("name", NAMES)
def test_loader_queries_match_oracle(built, data, name):
    idx = built[name][0]
    rng = np.random.default_rng(5)
    for _ in range(8):
        c = rng.random(2)
        w = rng.uniform(0.01, 0.06)
        res, _ = window_query(idx, c - w, c + w)
        assert sorted(res.tolist()) == sorted(window_oracle(data, c - w, c + w).tolist())


@pytest.mark.parametrize("name", ["hilbert", "str", "omt", "waffle"])
def test_packed_loaders_are_full(built, name):
    assert leaf_stats(built[name][0]).avg_fill > 0.98


def test_kdb_leaves_not_packed(built):
    # paper Table 1: KDB has the highest leaf count
    assert leaf_stats(built["kdb"][0]).count > leaf_stats(built["str"][0]).count


def test_paper_construction_cost_ordering(built):
    """Fig 7 top-left: FMBI < Hilbert < STR < the top-down methods."""
    cost = {n: b[1]["total"] for n, b in built.items()}
    assert cost["fmbi"] < cost["hilbert"] < cost["str"]
    for heavy in ("omt", "kdb", "waffle"):
        assert cost["str"] < cost[heavy]


def test_fmbi_area_is_competitive(built):
    """Table 1 / Fig 4: FMBI's leaf area at or below the packed variants';
    Hilbert's the worst (overlap)."""
    area = {n: leaf_stats(b[0]).total_area for n, b in built.items()}
    assert area["fmbi"] <= min(area["str"], area["omt"]) * 1.1
    assert area["hilbert"] > area["fmbi"]


@pytest.mark.parametrize("name", NAMES)
def test_tree_io_and_metrics_equal_the_reference(built, name):
    idx, io, ref, ref_io = built[name]
    for col in NodeTable.COLUMNS:
        got, want = getattr(idx.table, col), getattr(ref.table, col)
        assert got.dtype == want.dtype, col
        np.testing.assert_array_equal(got, want, err_msg=col)
    assert io == ref_io
    assert leaf_stats(idx).as_row() == ref_metrics.leaf_stats(ref).as_row()
    assert overlap_area_2d(idx) == ref_metrics.overlap_area_2d(ref)
    if name == "hilbert":
        assert overlap_area_2d(idx) > 0.0     # Hilbert leaves overlap
    if name == "fmbi":
        assert overlap_area_2d(idx) == 0.0


def _brute_d2(pts32, q):
    acc = np.zeros(len(pts32), dtype=np.float32)
    for k in range(pts32.shape[1]):
        diff = pts32[:, k] - q[k]
        acc = acc + diff * diff
    return acc


@pytest.mark.parametrize("name", NAMES)
def test_device_engine_over_each_tree_matches_queries_jax(built, data, name):
    idx, _, ref, _ = built[name]
    rng = np.random.default_rng(7)
    centres = (rng.random((64, 2)) * 0.9).astype(np.float32)
    los, his = centres - np.float32(0.01), centres + np.float32(0.01)
    qs = rng.random((32, 2)).astype(np.float32)
    dev = DeviceTable.from_index(idx, device="cpu")
    jdev = JaxTable.from_index(ref)
    got = window_query_batch_torch(dev, los, his)
    want = window_query_batch_jax(jdev, los, his)
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(np.sort(a), np.sort(np.asarray(b)))
        np.testing.assert_array_equal(np.sort(a), window_oracle(data, los[i], his[i]))
    ids, d2 = knn_query_batch_torch(dev, qs, K, return_dists=True)
    jids, jd2 = knn_query_batch_jax(jdev, qs, K, return_dists=True)
    pts32 = data.astype(np.float32)
    for i, q in enumerate(qs):
        np.testing.assert_allclose(d2[i], np.asarray(jd2[i]), rtol=1e-6)
        full = _brute_d2(pts32, q)
        np.testing.assert_array_equal(d2[i], np.sort(full)[:K])
        np.testing.assert_array_equal(full[ids[i]], d2[i])
