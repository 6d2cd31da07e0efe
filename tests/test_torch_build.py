"""The port's host layers against the JAX package's (PyTorch port).

The port keeps its own copies of the NumPy construction modules; these
tests hold the copies to the originals: the FMBI bulk load gives the same
``NodeTable`` columns, ``perm`` and ``IOStats``; the device layout gives the
same arrays (the compressed bounds as the same bf16 bit patterns, which the
port returns as ``np.uint16``); and state carried across (table columns or
a snapshot the JAX package wrote) round-trips.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import PageStore as RefPageStore
from repro.core import bulk_load as ref_bulk_load
from repro.core.fmbi import Index as RefIndex
from repro.core.nodetable import _bf16_outward as ref_bf16_outward
from repro_torch.core import (
    DeviceTable,
    Index,
    NodeTable,
    PageStore,
    UploadStats,
    bulk_load,
    index_from_arrays,
    table_from_arrays,
    window_query_batch_torch,
)
from repro_torch.core.nodetable import _bf16_outward

from engines import f32_points

COLUMNS = NodeTable.COLUMNS


def _columns(table):
    return {c: getattr(table, c) for c in COLUMNS}


def _assert_same_table(a, b):
    assert a.dim == b.dim and a.n_nodes == b.n_nodes and a.n_perm == b.n_perm
    for c in COLUMNS:
        np.testing.assert_array_equal(getattr(a, c), getattr(b, c), err_msg=c)


def _both(pts, m, seed):
    ref = ref_bulk_load(pts, m, RefPageStore(m), rng=np.random.default_rng(seed))
    got = bulk_load(pts, m, PageStore(m), rng=np.random.default_rng(seed))
    return ref, got


@pytest.mark.parametrize("kind,d,seed", [
    ("uniform", 2, 0), ("skew", 2, 1), ("grid", 2, 2), ("uniform", 3, 3),
    ("skew", 5, 4),
])
def test_bulk_load_matches_reference(kind, d, seed):
    pts = f32_points(5000, d, seed, kind)
    ref, got = _both(pts, 120, seed)
    _assert_same_table(ref.table, got.table)
    assert dataclasses.asdict(got.store.stats) == dataclasses.asdict(ref.store.stats)
    assert got.store.allocated_pages == ref.store.allocated_pages
    assert (got.leaf_cap, got.branch_cap) == (ref.leaf_cap, ref.branch_cap)
    got.table.check_invariants(len(pts))


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("kind", ["uniform", "grid", "skew"])
def test_device_layout_matches_reference(kind, compressed):
    pts = f32_points(4000, 2, 11, kind)
    ref, got = _both(pts, 120, 5)
    a = ref.table.device_layout(pts, compressed=compressed)
    b = got.table.device_layout(pts, compressed=compressed)
    assert set(a) == set(b)
    for key in a:
        if key == "levels":
            continue
        want = a[key]
        if key.endswith("_c"):
            assert b[key].dtype == np.uint16
            want = want.view(np.uint16)
        np.testing.assert_array_equal(b[key], want, err_msg=key)
    assert len(a["levels"]) == len(b["levels"])
    for la, lb in zip(a["levels"], b["levels"]):
        assert set(la) == set(lb)
        for key in la:
            want = la[key].view(np.uint16) if key.endswith("_c") else la[key]
            np.testing.assert_array_equal(lb[key], want, err_msg=key)


def test_bf16_outward_bit_patterns_match_reference():
    f = np.finfo(np.float32)
    probes = np.array(
        [0.0, -0.0, 1.0, -1.0, 1.0 + 2**-20, -(1.0 + 2**-20), f.tiny, -f.tiny,
         f.tiny / 8, -f.tiny / 8, f.max, -f.max, np.inf, -np.inf, 3.3e38,
         -3.3e38, 0.1, -0.1, 65504.0, 1e-30],
        dtype=np.float32,
    )
    rand = np.random.default_rng(0).normal(0, 1e3, 2000).astype(np.float32)
    x = np.concatenate([probes, rand])
    for up in (False, True):
        got = _bf16_outward(x, up)
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, ref_bf16_outward(x, up).view(np.uint16))
        widened = (got.astype(np.uint32) << 16).view(np.float32)
        finite = np.isfinite(x)
        if up:
            assert np.all(widened[finite] >= x[finite])
        else:
            assert np.all(widened[finite] <= x[finite])


def test_table_from_arrays_round_trips():
    pts = f32_points(3000, 2, 8)
    ref, got = _both(pts, 120, 2)
    carried = table_from_arrays(2, _columns(ref.table))
    _assert_same_table(carried, got.table)
    assert carried.equals(got.table)
    carried.check_invariants(len(pts))
    with pytest.raises(ValueError, match="missing"):
        table_from_arrays(2, {c: v for c, v in _columns(ref.table).items()
                              if c != "perm"})
    bad = _columns(ref.table)
    bad["leaf_count"] = bad["leaf_count"][:-1]
    with pytest.raises(ValueError, match="rows"):
        table_from_arrays(2, bad)


def test_index_from_arrays_answers_like_the_built_index():
    pts = f32_points(3000, 2, 9)
    ref, got = _both(pts, 120, 4)
    carried = index_from_arrays(_columns(ref.table), pts, buffer_pages=120)
    assert isinstance(carried, Index)
    assert carried.store.allocated_pages == int(ref.table.page_id.max()) + 1
    rng = np.random.default_rng(1)
    c = rng.random((16, 2)).astype(np.float32)
    los, his = c - 0.05, c + 0.05
    a = window_query_batch_torch(DeviceTable.from_index(carried, device="cpu"), los, his)
    b = window_query_batch_torch(DeviceTable.from_index(got, device="cpu"), los, his)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.sort(x), np.sort(y))


def test_reference_snapshot_loads(tmp_path):
    pts = f32_points(3000, 3, 10)
    ref, got = _both(pts, 120, 6)
    path = tmp_path / "ref_index.npz"
    ref.save(path)
    table, meta, points = NodeTable.load(path)
    _assert_same_table(table, got.table)
    np.testing.assert_array_equal(points, pts)
    assert int(meta["buffer_pages"]) == 120
    idx = Index.load(path)
    _assert_same_table(idx.table, got.table)
    assert idx.store.allocated_pages == ref.store.allocated_pages
    # and the other way round: the JAX package reads the port's snapshot
    path2 = tmp_path / "port_index.npz"
    got.save(path2)
    _assert_same_table(RefIndex.load(path2).table, got.table)


def test_device_table_upload_stats_are_per_instance():
    pts = f32_points(2000, 2, 12)
    _, got = _both(pts, 120, 1)
    mine = UploadStats()
    a = DeviceTable.from_index(got, device="cpu", stats=mine)
    b = DeviceTable.from_index(got, device="cpu", compressed=True)
    assert mine.full_exports == 1
    assert mine.uploaded_points == len(pts) == a.live_points()
    assert mine.uploaded_leaf_blocks == a.n_leaves
    assert b.upload_stats is not mine and b.upload_stats.full_exports == 1
    assert a.leaf_lo_c is None and b.leaf_lo_c.dtype == torch.bfloat16
    assert a.device.type == "cpu" and a.leaf_pts.dtype == torch.float32
    assert (a.n_leaves, a.leaf_size, a.dim, a.n_cold) == (
        b.n_leaves, b.leaf_size, 2, 0)
