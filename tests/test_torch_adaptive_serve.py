"""Adaptive serving of the PyTorch port against the JAX package's:
``DeviceQueryServer`` over AMBI, ``DeviceTable.apply_delta`` and the
resilience plane.

The reference's scenarios (``tests/test_adaptive_serve.py``) run through
``repro.serve.engine.DeviceQueryServer`` (JAX on the CPU) and through the
port's twin with ``device="cpu"``, where every kernel runs as its plain
version.  Data are continuous and float32-representable
(``engines.f32_points``), so the f64 k-th distance that splits hot from
cold queries, and with it the refinement sequence, is the same on both
sides.  Contract:

  * windows: equal id sets, and equal to the NumPy oracle;
  * k-NN: equal f64 distance sequences, and equal ids where the oracle's
    k-th distance is strictly below its (k+1)-th;
  * equal ``DeviceQueryStats`` counters and ``upload_stats``, and equal
    final AMBI tables (every ``NodeTable`` column) and ``IOStats``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import AMBI as RefAMBI
from repro.core.queries_jax import DeviceTable as RefTable
from repro.serve.engine import DeviceQueryServer as RefServer
from repro.serve.faults import FaultPlan as RefFaultPlan
from repro.serve.faults import FaultRule as RefFaultRule
from repro_torch.core import AMBI, NodeTable, PageStore, bulk_load
from repro_torch.core import queries_torch as QT
from repro_torch.core.queries import knn_oracle, knn_query_batch, window_oracle
from repro_torch.serve import DeviceQueryServer, FaultPlan
from repro_torch.serve.faults import FaultRule

from engines import f32_points

CPU = "cpu"


def _stream(d, steps, per_step, seed):
    """The reference scenario's hotspot stream: two centres, alternating."""
    rng = np.random.default_rng(seed)
    centers = [np.full(d, 0.3), np.full(d, 0.7)]
    return [(centers[s % 2] + rng.random((per_step, d)) * 0.08)
            .astype(np.float32).astype(np.float64) for s in range(steps)]


def _servers(pts, M, fault_plans=(None, None), **kw):
    """The reference's adaptive server and the port's, each over its own
    AMBI of ``pts`` (``fault_plans``: one plan for each)."""
    ref = RefServer.from_ambi(RefAMBI(pts, M), fault_plan=fault_plans[0], **kw)
    port = DeviceQueryServer.from_ambi(AMBI(pts, M), fault_plan=fault_plans[1],
                                       device=CPU, **kw)
    return ref, port


def _check_windows(pts, los, his, got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(np.sort(g), np.sort(w)), i
        assert np.array_equal(np.sort(g), window_oracle(pts, los[i], his[i])), i


def _check_knn(pts, qs, k, got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        dg = np.sum((pts[g] - qs[i]) ** 2, axis=1)
        dw = np.sum((pts[w] - qs[i]) ** 2, axis=1)
        assert np.array_equal(dg, dw), i
        full = np.sort(np.sum((pts - qs[i]) ** 2, axis=1))
        assert np.array_equal(np.sort(dg), full[: len(dg)]), i
        if len(full) > k and full[k - 1] < full[k]:
            assert set(g.tolist()) == set(knn_oracle(pts, qs[i], k).tolist()), i


def _assert_same(ref, port):
    """Equal serving counters (the port's fields), upload counters and
    AMBI tables."""
    r, p = dataclasses.asdict(ref.stats), dataclasses.asdict(port.stats)
    assert {k: r[k] for k in p} == p
    assert all(v == 0 for k, v in r.items() if k not in p)
    assert ref.upload_stats.as_dict() == port.upload_stats.as_dict()
    for c in NodeTable.COLUMNS:
        assert np.array_equal(getattr(ref.ambi.table, c), getattr(port.ambi.table, c)), c
    rs, ps = ref.ambi.store.stats, port.ambi.store.stats
    assert (rs.reads, rs.writes) == (ps.reads, ps.writes)
    assert (ref.dev.n_leaves, ref.dev.n_cold) == (port.dev.n_leaves, port.dev.n_cold)


# --------------------------------------------------------------------------
# the reference's acceptance scenario: unrefined-root boot, delta uploads
# --------------------------------------------------------------------------
@pytest.mark.parametrize("compressed", [False, True])
def test_hotspot_stream_parity_and_delta_uploads(compressed):
    pts = f32_points(40_000, 2, 0)
    ref, port = _servers(pts, 80, microbatch=8, compressed=compressed)
    assert port.upload_stats["full_exports"] == 1
    assert port.dev.n_leaves == 0 and port.dev.n_cold == 1
    assert port.dev.compressed == compressed
    for batch in _stream(2, 10, 8, 1):
        los, his = batch - 0.02, batch + 0.02
        _check_windows(pts, los, his, port.window(los, his), ref.window(los, his))
        _check_knn(pts, batch, 8, port.knn(batch, 8), ref.knn(batch, 8))
        _assert_same(ref, port)
    assert not port.ambi.is_fully_refined()
    st, up = port.stats, port.upload_stats
    assert st.cold_queries > 0 and st.hot_queries > 0
    assert st.grafts > 0 and st.delta_refreshes > 0
    assert up["full_exports"] == 1
    assert up["delta_refreshes"] == st.delta_refreshes
    assert up["uploaded_leaf_blocks"] == port.dev.n_leaves
    assert up["uploaded_points"] == port.dev.n_points
    # the delta refresh seeded the host id blocks: nothing left to copy
    assert "host_ids" in vars(port.dev)
    assert np.array_equal(port.dev.host_ids, port.dev.leaf_ids.numpy())
    port.ambi.table.check_invariants(len(pts))
    # steady state: replaying the hotspots is all-device, with no I/O
    cold, io = st.cold_queries, port.ambi.store.stats.total
    for batch in _stream(2, 4, 8, 1)[:2]:
        port.window(batch - 0.02, batch + 0.02)
        port.knn(batch, 8)
    assert port.stats.cold_queries == cold
    assert port.ambi.store.stats.total == io


def test_converges_to_refined_and_stays_device_only():
    pts = f32_points(40_000, 2, 3)
    ambi = AMBI(pts, 80)
    srv = DeviceQueryServer.from_ambi(ambi, microbatch=4, device=CPU)
    res = srv.window(np.zeros((1, 2)), np.ones((1, 2)))
    assert len(res[0]) == len(pts)
    assert ambi.is_fully_refined()
    assert srv.dev.n_cold == 0
    idx = bulk_load(pts, 250, PageStore(250))
    qs = f32_points(8, 2, 4)
    want, _ = knn_query_batch(idx, qs, 16)
    for a, b in zip(srv.knn(qs, 16), want):
        assert np.array_equal(a, b)
    assert srv.stats.cold_queries == 1  # only the covering window


# --------------------------------------------------------------------------
# apply_delta against a fresh partial export
# --------------------------------------------------------------------------
def _leaf_key(dev):
    ids = dev.leaf_ids.numpy()
    return sorted(tuple(sorted(row[row >= 0])) for row in ids)


def _same_as_fresh(dev, fresh, pts, rng):
    assert (dev.n_leaves, dev.n_cold, dev.n_points, dev.leaf_size) == (
        fresh.n_leaves, fresh.n_cold, fresh.n_points, fresh.leaf_size)
    assert dev.compressed == fresh.compressed
    assert _leaf_key(dev) == _leaf_key(fresh)
    assert np.array_equal(dev.host_ids, dev.leaf_ids.numpy())
    assert np.array_equal(dev.cold_rows, fresh.cold_rows)
    qs = (rng.random((16, 2)) * 0.8 + 0.1).astype(np.float32).astype(np.float64)
    los, his = qs - 0.03, qs + 0.03
    for fused in (True, False):
        rw, rc = QT.window_query_batch_torch(dev, los, his, fused=fused, return_cold=True)
        fw, fc = QT.window_query_batch_torch(fresh, los, his, fused=fused,
                                             return_cold=True)
        for a, b in zip(rw, fw):
            assert np.array_equal(np.sort(a), np.sort(b))
        assert np.array_equal(rc, fc)   # cold slots follow the table rows
    # leaf slot order differs from the fresh export's, so the frontier
    # hit masks must agree once mapped through leaf_rows
    qlo, qhi = (torch.from_numpy(x.astype(np.float32)) for x in (los, his))
    hd = QT.frontier_leaf_hits(dev, qlo, qhi, compressed=dev.compressed).numpy()
    hf = QT.frontier_leaf_hits(fresh, qlo, qhi, compressed=fresh.compressed).numpy()
    order_d = np.argsort(dev.leaf_rows)
    order_f = np.argsort(fresh.leaf_rows)
    assert np.array_equal(hd[:, order_d], hf[:, order_f])
    for fused in (True, False):
        rk, rd = QT.knn_query_batch_torch(dev, qs, 8, fused=fused, return_dists=True)
        fk, fd = QT.knn_query_batch_torch(fresh, qs, 8, fused=fused, return_dists=True)
        for a, b in zip(rd, fd):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("compressed", [False, True])
def test_apply_delta_matches_fresh_export_and_the_reference(compressed):
    pts = f32_points(40_000, 2, 7)
    ambi, ref_ambi = AMBI(pts, 80), RefAMBI(pts, 80)
    dev = QT.DeviceTable.from_table(ambi.table, pts, partial=True,
                                    compressed=compressed, device=CPU)
    rdev = RefTable.from_table(ref_ambi.table, pts, partial=True,
                               compressed=compressed, stats=None)
    rng = np.random.default_rng(8)
    for step in range(4):
        c = rng.random(2) * 0.6 + 0.2
        ambi.window(c - 0.02, c + 0.02)
        ref_ambi.window(c - 0.02, c + 0.02)
        n_before = dev.n_leaves
        before = dev.upload_stats.reset()   # the last step's counts, then zeros
        assert (before["full_exports"], before["delta_refreshes"]) == (
            (1, 0) if step == 0 else (0, 1))
        dev = dev.apply_delta(ambi.table, pts)
        rdev = rdev.apply_delta(ref_ambi.table, pts)
        shipped = dev.upload_stats["uploaded_leaf_blocks"]
        assert dev.upload_stats.as_dict() == {
            "full_exports": 0, "delta_refreshes": 1, "uploaded_leaf_blocks": shipped,
            "uploaded_points": dev.upload_stats["uploaded_points"]}
        fresh = QT.DeviceTable.from_table(ambi.table, pts, partial=True,
                                          compressed=compressed, device=CPU)
        assert shipped == fresh.n_leaves - n_before
        if step:
            assert shipped < fresh.n_leaves
        assert np.array_equal(dev.leaf_rows, rdev.leaf_rows)
        assert np.array_equal(dev.host_ids, rdev.host_ids)
        _same_as_fresh(dev, fresh, pts, rng)


@pytest.mark.parametrize("compressed", [False, True])
def test_apply_delta_widens_the_leaf_blocks(compressed):
    """A delta whose new leaves are fuller than every leaf the export
    holds pads the old blocks on the device (f32 max, id -1) to the new
    stride and re-rounds the compressed bounds."""
    pts = f32_points(40_000, 2, 9)
    ambi = AMBI(pts, 80)
    for c in (0.25, 0.5, 0.75):
        ambi.window(np.full(2, c - 0.02), np.full(2, c + 0.02))
    full = QT.DeviceTable.from_table(ambi.table, pts, partial=True,
                                     compressed=compressed, device=CPU)
    counts = full.leaf_counts.numpy()
    keep = np.flatnonzero(counts < counts.max())
    assert 0 < len(keep) < full.n_leaves
    s = int(counts[keep].max())
    # the export as it stood before the fullest leaves were grafted
    old = dataclasses.replace(
        full, leaf_pts=full.leaf_pts[keep, :s].contiguous(),
        leaf_ids=full.leaf_ids[keep, :s].contiguous(),
        leaf_counts=full.leaf_counts[keep], leaf_lo=full.leaf_lo[keep],
        leaf_hi=full.leaf_hi[keep],
        leaf_lo_c=full.leaf_lo_c[keep] if compressed else None,
        leaf_hi_c=full.leaf_hi_c[keep] if compressed else None,
        n_points=int(counts[keep].sum()), leaf_rows=full.leaf_rows[keep])
    old.host_ids = old.leaf_ids.numpy()
    dev = old.apply_delta(ambi.table, pts)
    assert old.leaf_size == s < dev.leaf_size == full.leaf_size
    assert (dev.leaf_ids[: len(keep), s:] == -1).all()
    assert (dev.leaf_pts[: len(keep), s:] == QT.BIG).all()
    _same_as_fresh(dev, full, pts, np.random.default_rng(10))


def test_apply_delta_needs_the_host_maps():
    pts = f32_points(20_000, 2, 9)
    idx = bulk_load(pts, 100, PageStore(100))
    dev = dataclasses.replace(QT.DeviceTable.from_index(idx, device=CPU),
                              leaf_rows=None)
    with pytest.raises(ValueError, match="scaffolding"):
        dev.apply_delta(idx.table, pts)


# --------------------------------------------------------------------------
# compaction, brownout tier, static serving
# --------------------------------------------------------------------------
def test_compact_under_zero_slack_keeps_answers_exact():
    pts = f32_points(40_000, 2, 12)
    ref, port = _servers(pts, 80, microbatch=4, compact_slack=0.0)
    rng = np.random.default_rng(13)
    for _ in range(5):
        c = (rng.random((4, 2)) * 0.7 + 0.15).astype(np.float32).astype(np.float64)
        _check_windows(pts, c - 0.03, c + 0.03, port.window(c - 0.03, c + 0.03),
                       ref.window(c - 0.03, c + 0.03))
        _check_knn(pts, c, 6, port.knn(c, 6), ref.knn(c, 6))
    assert port.stats.compactions >= 2
    assert port.stats.compactions == ref.stats.compactions
    _assert_same(ref, port)
    t = port.ambi.table
    assert np.all(t.is_leaf_row(port.dev.leaf_rows))
    assert np.all(t.unrefined[port.dev.cold_rows])
    assert np.array_equal(port.dev.leaf_rows, ref.dev.leaf_rows)


def test_brownout_tier_certificates_match_reference():
    pts = f32_points(40_000, 2, 14)
    ref, port = _servers(pts, 80, microbatch=8)
    for batch in _stream(2, 4, 8, 2):
        ref.window(batch - 0.02, batch + 0.02), port.window(batch - 0.02, batch + 0.02)
    rng = np.random.default_rng(15)
    qs = rng.random((24, 2)).astype(np.float32).astype(np.float64)
    qs[:8] = _stream(2, 1, 8, 2)[0]   # some queries inside refined space
    los, his = qs - 0.01, qs + 0.01
    cold = port.cold_window_mask(los, his)
    assert np.array_equal(cold, ref.cold_window_mask(los, his))
    (rw, rwc), (pw, pwc) = ref.window_hot(los, his), port.window_hot(los, his)
    (rk, rkc), (pk, pkc) = ref.knn_hot(qs, 8), port.knn_hot(qs, 8)
    n_complete = 0
    for i in range(len(qs)):
        assert np.array_equal(np.sort(rw[i]), np.sort(pw[i]))
        assert np.array_equal(rk[i], pk[i])
        for a, b in ((rwc[i], pwc[i]), (rkc[i], pkc[i])):
            assert (a.complete, a.certified_exact, a.missing_shards) == (
                b.complete, b.certified_exact, b.missing_shards)
            for x, y in ((a.missing_lo, b.missing_lo), (a.missing_hi, b.missing_hi)):
                assert (x is None and y is None) or np.array_equal(x, y)
        assert pwc[i].complete == (not cold[i])
        if pwc[i].complete:
            n_complete += 1
            assert np.array_equal(np.sort(pw[i]), window_oracle(pts, los[i], his[i]))
    assert 0 < n_complete < len(qs)
    _assert_same(ref, port)


def test_static_serving_from_index_and_snapshot(tmp_path):
    pts = f32_points(20_000, 2, 16)
    idx = bulk_load(pts, 100, PageStore(100))
    path = tmp_path / "index.npz"
    idx.save(path)
    rng = np.random.default_rng(17)
    qs = rng.random((20, 2)).astype(np.float32).astype(np.float64)
    for srv in (DeviceQueryServer.from_index(idx, microbatch=6, device=CPU),
                DeviceQueryServer.from_snapshot(path, microbatch=6, compressed=True,
                                                device=CPU)):
        got, certs = srv.window(qs - 0.05, qs + 0.05, return_certs=True)
        assert all(c.complete and c.certified_exact for c in certs)
        for i, g in enumerate(got):
            assert np.array_equal(np.sort(g), window_oracle(pts, qs[i] - 0.05, qs[i] + 0.05))
        _check_knn(pts, qs, 5, srv.knn(qs, 5), [knn_oracle(pts, q, 5) for q in qs])
        assert srv.stats.microbatches == 8 and srv.stats.queries == 40
        assert srv.cold_window_mask(qs - 0.05, qs + 0.05).sum() == 0
        assert srv.window_hot(qs, qs)[1][0].complete


def test_static_outage_degrades_and_repairs():
    pts = f32_points(20_000, 2, 18)
    idx = bulk_load(pts, 100, PageStore(100))
    plan = FaultPlan([FaultRule("shard_dispatch", at_calls={1, 2, 3})])
    srv = DeviceQueryServer.from_index(idx, fault_plan=plan, microbatch=8,
                                       breaker_threshold=1, device=CPU)
    qs = f32_points(8, 2, 19)
    with pytest.raises(Exception, match="unavailable"):
        srv.knn(qs, 4)
    assert srv.stats.retries == 2
    got, certs = srv.window(qs - 0.1, qs + 0.1, return_certs=True)
    assert all(not c.complete and c.missing_shards == (0,) for c in certs)
    assert all(len(g) == 0 for g in got) and srv.stats.degraded_queries == 8
    assert srv.repair() == [0]
    got, certs = srv.window(qs - 0.1, qs + 0.1, return_certs=True)
    assert all(c.complete for c in certs)
    for i, g in enumerate(got):
        assert np.array_equal(np.sort(g), window_oracle(pts, qs[i] - 0.1, qs[i] + 0.1))
    assert srv.upload_stats["full_exports"] == 2


@pytest.mark.parametrize("stage", ["window", "knn", "host_refine", "apply_delta"])
def test_device_errors_propagate_unretried(stage, monkeypatch):
    """Only an injected FaultError is retried or answered on the host: an
    error of the device engine (a kernel that fails to build or launch)
    reaches the caller on the first attempt, with no host fallback."""
    import repro_torch.serve.engine as E

    def broken(*a, **kw):
        raise RuntimeError("kernel launch failed")

    pts = f32_points(20_000, 2, 22)
    srv = DeviceQueryServer.from_ambi(AMBI(pts, 100), microbatch=8, device=CPU)
    target = {"window": (E, "window_query_batch_torch"),
              "knn": (E, "knn_query_batch_torch"),
              "host_refine": (srv.ambi, "window"),
              "apply_delta": (QT.DeviceTable, "apply_delta")}[stage]
    monkeypatch.setattr(*target, broken)
    qs = f32_points(8, 2, 23)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        if stage == "knn":
            srv.knn(qs, 4)
        else:
            srv.window(qs - 0.01, qs + 0.01)
    s = srv.stats
    assert (s.retries, s.host_fallbacks, s.degraded_queries) == (0, 0, 0)
    assert all(br.state == "closed" for br in srv.breakers.values())


# --------------------------------------------------------------------------
# fault plans on the adaptive path: exact answers, the reference's counts
# --------------------------------------------------------------------------
@pytest.mark.parametrize("point,calls", [
    ("shard_dispatch", {1}),
    ("shard_dispatch", {2, 3, 4}),
    ("apply_delta", {1}),
    ("apply_delta", {1, 2, 3}),
    ("host_refine", {2}),
    ("pagestore_read", {3}),
])
def test_fault_plans_keep_answers_exact(point, calls):
    pts = f32_points(40_000, 2, 20)
    plans = (RefFaultPlan([RefFaultRule(point, at_calls=set(calls))]),
             FaultPlan([FaultRule(point, at_calls=set(calls))]))
    ref, port = _servers(pts, 80, microbatch=8, fault_plans=plans)
    for batch in _stream(2, 4, 8, 3):
        los, his = batch - 0.02, batch + 0.02
        _check_windows(pts, los, his, port.window(los, his), ref.window(los, his))
        _check_knn(pts, batch, 8, port.knn(batch, 8), ref.knn(batch, 8))
    assert plans[1].fires_at(point) == plans[0].fires_at(point) == len(calls)
    assert port.stats.retries == ref.stats.retries > 0
    assert port.stats.host_fallbacks == ref.stats.host_fallbacks
    if point == "shard_dispatch" and len(calls) == 3:
        assert port.stats.host_fallbacks > 0
    _assert_same(ref, port)


def test_not_ported_options_raise(tmp_path):
    """``shards=2`` serves (sharded serving is ported) with the single
    device's answers; the options the slices ported raise the reference's
    ``ValueError``s where they do not apply."""
    pts = f32_points(20_000, 2, 21)
    idx = bulk_load(pts, 100, PageStore(100))
    sharded = DeviceQueryServer.from_index(idx, device=CPU, shards=2)
    srv = DeviceQueryServer.from_index(idx, device=CPU)
    assert sharded.stats.shards == sharded.sdev.m == 2 and sharded.dev is None
    qs = f32_points(12, 2, 24)
    for a, b in zip(sharded.window(qs - 0.05, qs + 0.05), srv.window(qs - 0.05, qs + 0.05)):
        assert np.array_equal(np.sort(a), np.sort(b))
    for a, b in zip(sharded.knn(qs, 6), srv.knn(qs, 6)):
        assert np.array_equal(a, b)
    for name in ("insert", "delete", "checkpoint", "from_streaming", "recover"):
        assert hasattr(srv, name), name
    with pytest.raises(ValueError, match="static"):
        srv.insert(pts[:3])
    with pytest.raises(ValueError, match="static"):
        srv.delete([0])
    with pytest.raises(ValueError, match="static table"):   # journaling a static table
        DeviceQueryServer.from_index(idx, device=CPU, journal_path=tmp_path / "j",
                                     snapshot_path=tmp_path / "s.npz")
    with pytest.raises(ValueError, match="BOTH"):   # journal_path without snapshot_path
        DeviceQueryServer.from_ambi(AMBI(pts, 100), device=CPU, journal_path=tmp_path / "j")
    with pytest.raises(ValueError, match="stream="):
        DeviceQueryServer(None, None, adaptive=True, ambi=AMBI(pts, 100),
                          stream=object(), device=CPU)
    with pytest.raises(ValueError, match="no snapshot_path"):
        srv.checkpoint()
    with pytest.raises(ValueError, match="from_ambi"):
        DeviceQueryServer(idx.table, pts, adaptive=True, device=CPU)
    with pytest.raises(ValueError, match="NaN"):
        srv.knn(np.array([[np.nan, 0.5]]), 3)
