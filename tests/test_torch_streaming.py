"""Streaming ingest of the PyTorch port against the JAX package's:
``StreamingIndex``, ``DeviceMirror`` and ``DeviceQueryServer.from_streaming``
with the adaptive server's streaming overlay.

The reference's scenarios (``tests/test_streaming.py``) run through
``repro`` (JAX on the CPU) and through the port with ``device="cpu"``,
where every kernel runs as its plain version.  Points, inserts and
queries are float32-representable, so the device's f32 answers and the
host's f64 re-ranking agree with one brute-force oracle.  Contract:

  * windows: equal id sets, and equal to the rebuild oracle's;
  * k-NN: equal id sequences (the streaming contract ranks by f64
    distance, ties by id);
  * equal ids at insert, equal delete counts;
  * equal tier tables and mirror tables (every ``NodeTable`` column),
    equal ``sync()`` summaries, ``DeviceQueryStats`` and ``upload_stats``.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import StreamingIndex as RefStream
from repro.serve.engine import DeviceQueryServer as RefServer
from repro.serve.faults import FaultPlan as RefFaultPlan
from repro.serve.faults import FaultRule as RefFaultRule
from repro.serve.resilience import RetryPolicy as RefRetryPolicy
from repro_torch.core import AMBI, DeviceMirror, NodeTable, StreamingIndex
from repro_torch.core import queries_torch as QT
from repro_torch.serve import (
    DeviceQueryServer,
    FaultPlan,
    FaultRule,
    RetryPolicy,
    StreamSyncError,
)

from engines import (
    STREAM_KW,
    OverlayServerEngine,
    RebuildOracle,
    StreamingHostEngine,
    StreamingServerEngine,
    f32_points,
)

CPU = "cpu"


def _f32(a):
    return np.asarray(a, dtype=np.float32).astype(np.float64)


# --------------------------------------------------------------------------
# the port's engines (the reference's are in engines.py)
# --------------------------------------------------------------------------
class PortHost:
    name = "port-stream-host"

    def __init__(self, pts, **kw):
        self.stream = StreamingIndex(np.asarray(pts, np.float64), **{**STREAM_KW, **kw})

    def insert(self, pts):
        return self.stream.insert(pts)

    def delete(self, ids):
        return self.stream.delete(ids)

    def window(self, los, his):
        return self.stream.window(np.atleast_2d(los), np.atleast_2d(his))

    def knn(self, qs, k):
        return self.stream.knn(np.atleast_2d(qs), k)


class PortServer(PortHost):
    name = "port-stream-server"

    def __init__(self, pts, stream_kw=None, **server_kw):
        self.stream = StreamingIndex(np.asarray(pts, np.float64),
                                     **{**STREAM_KW, **(stream_kw or {})})
        self.srv = DeviceQueryServer.from_streaming(self.stream, microbatch=32,
                                                    device=CPU, **server_kw)

    def insert(self, pts):
        return self.srv.insert(pts)

    def delete(self, ids):
        return self.srv.delete(ids)

    def window(self, los, his):
        return self.srv.window(np.atleast_2d(los), np.atleast_2d(his))

    def knn(self, qs, k):
        return self.srv.knn(np.atleast_2d(qs), k)


class PortOverlay(PortServer):
    name = "port-adaptive-overlay"

    def __init__(self, pts, M=250, **kw):
        self.srv = DeviceQueryServer.from_ambi(AMBI(np.asarray(pts, np.float64), M),
                                               microbatch=32, device=CPU, **kw)
        self.srv.OVERLAY_KW = dict(STREAM_KW)


def _record_syncs(srv):
    """Keep every ``DeviceMirror.sync()`` summary of a streaming server."""
    seen = []
    orig = srv.mirror.sync

    def sync():
        info = orig()
        seen.append(info)
        return info

    srv.mirror.sync = sync
    return seen


def _same_table(a, b, what):
    assert a.n_nodes == b.n_nodes, what
    for c in NodeTable.COLUMNS:
        assert np.array_equal(getattr(a, c), getattr(b, c)), (what, c)


def _same_stream(ref, port, counters=True):
    """Equal host state: points, tombstones, delta, tiers (rows and every
    table column), counters (a loaded snapshot starts them at 0) and the
    page store."""
    assert ref.n_ids == port.n_ids and ref.shadow == port.shadow
    assert np.array_equal(ref.points, port.points)
    assert np.array_equal(ref.live_mask(), port.live_mask())
    assert np.array_equal(ref.delta_live_rows(), port.delta_live_rows())
    assert [(t.tid, t.fused) for t in ref.tiers] == [(t.tid, t.fused) for t in port.tiers]
    for rt, pt in zip(ref.tiers, port.tiers):
        assert np.array_equal(rt.rows, pt.rows)
        _same_table(rt.table, pt.table, f"tier {pt.tid}")
    for c in ("flushes", "merges", "fusions", "delta_rebuilds", "point_reallocs"):
        assert not counters or getattr(ref, c) == getattr(port, c), c
    assert ref.store.state_dict() == port.store.state_dict()


def _same_server(ref, port):
    r, p = dataclasses.asdict(ref.stats), dataclasses.asdict(port.stats)
    assert {k: r[k] for k in p} == p
    assert all(v == 0 for k, v in r.items() if k not in p)
    assert ref.upload_stats.as_dict() == port.upload_stats.as_dict()
    if ref.mirror is not None:
        _same_table(ref.mirror.table, port.mirror.table, "mirror")
        assert np.array_equal(ref.dev.leaf_rows, port.dev.leaf_rows)
        assert np.array_equal(ref.dev.host_ids, port.dev.host_ids)
    _same_stream(ref.stream, port.stream)


# --------------------------------------------------------------------------
# the interleaving driver of the reference, on both packages
# --------------------------------------------------------------------------
def _drive_interleaved(engines, seed, steps, max_ins=150, check_every=3, on_check=None):
    rng = np.random.default_rng(seed + 7919)
    n_ids = len(engines[0].pts)
    for step in range(steps):
        ins = _f32(rng.random((int(rng.integers(1, max_ins)), 2)))
        ids = [e.insert(ins) for e in engines]
        for got in ids[1:]:
            np.testing.assert_array_equal(got, ids[0])
        n_ids += len(ins)
        if step % 2 == 0:
            dels = rng.integers(0, n_ids, size=int(rng.integers(1, 30)))
            counts = [e.delete(dels) for e in engines]
            assert counts[1:] == [counts[0]] * (len(engines) - 1)
        if step % check_every == check_every - 1 or step == steps - 1:
            los = rng.random((4, 2)) * 0.7
            his = los + rng.uniform(0.05, 0.3)
            ref = engines[0].window(los, his)
            for e in engines[1:]:
                for i, (a, b) in enumerate(zip(e.window(los, his), ref)):
                    assert np.array_equal(np.sort(a), b), (e.name, step, i)
            qs = _f32(rng.random((4, 2)))
            kref = engines[0].knn(qs, 8)
            for e in engines[1:]:
                for i, (a, b) in enumerate(zip(e.knn(qs, 8), kref)):
                    assert np.array_equal(a, b), (e.name, step, i)
            if on_check is not None:
                on_check()


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_interleaved_schedule_matches_reference(seed):
    """The reference's engine matrix without the sharded server (host
    stream, single-device streaming server, adaptive overlay), each in
    both packages, against the rebuild oracle; tier and mirror tables,
    sync summaries and counters equal after every check."""
    pts = f32_points(2500, 2, seed=seed)
    ref_srv, port_srv = StreamingServerEngine(pts), PortServer(pts)
    ref_syncs, port_syncs = _record_syncs(ref_srv.srv), _record_syncs(port_srv.srv)
    ref_host, port_host = StreamingHostEngine(pts), PortHost(pts)
    ref_ov, port_ov = OverlayServerEngine(pts), PortOverlay(pts)
    engines = [RebuildOracle(pts), ref_host, port_host, ref_srv, port_srv, ref_ov, port_ov]

    def same():
        _same_stream(ref_host.stream, port_host.stream)
        _same_server(ref_srv.srv, port_srv.srv)
        _same_server(ref_ov.srv, port_ov.srv)
        for c in NodeTable.COLUMNS:
            assert np.array_equal(getattr(ref_ov.srv.ambi.table, c),
                                  getattr(port_ov.srv.ambi.table, c)), c

    _drive_interleaved(engines, seed, steps=22, on_check=same)
    assert len(port_syncs) == len(ref_syncs) > 0
    assert port_syncs == ref_syncs
    s = port_srv.stream
    assert s.flushes >= 2 and s.merges >= 1 and s.deleted > 0 and s.tiers
    assert port_srv.srv.upload_stats["full_exports"] == 1
    assert port_srv.srv.stats.delta_refreshes == port_srv.srv.stats.stream_syncs > 0


def test_tombstones_never_resurface():
    pts = f32_points(2000, 2, seed=4)
    kw = dict(delta_threshold=256, delta_index_every=64, size_ratio=2)
    s, ref = StreamingIndex(pts, **kw), RefStream(pts, **kw)
    rng = np.random.default_rng(4)
    doomed = np.unique(rng.integers(0, 2000, size=120))
    assert s.delete(doomed) == ref.delete(doomed) == len(doomed)
    peak_shadow = s.shadow
    lo, hi = np.zeros((1, 2)), np.ones((1, 2))
    for _ in range(20):
        batch = _f32(rng.random((200, 2)))
        np.testing.assert_array_equal(s.insert(batch), ref.insert(batch))
        everything = s.window(lo, hi)[0]
        assert not np.intersect1d(everything, doomed).size
        np.testing.assert_array_equal(everything, ref.window(lo, hi)[0])
        for a, b in zip(s.knn(pts[doomed[:4]], 4), ref.knn(pts[doomed[:4]], 4)):
            assert not np.intersect1d(a, doomed).size
            np.testing.assert_array_equal(a, b)
    assert s.fusions >= 1 and s.merges >= 1
    assert s.shadow < peak_shadow
    _same_stream(ref, s)


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 2**31 - 1),
       st.lists(st.tuples(st.integers(1, 120), st.integers(0, 25)), min_size=4, max_size=9))
def test_arbitrary_interleavings_match_the_reference(seed, script):
    """The reference's property test on the port's host stream, with the
    reference's stream beside it: equal ids, counts, answers and state."""
    rng = np.random.default_rng(seed)
    pts = _f32(rng.random((600, 2)))
    kw = dict(delta_threshold=256, delta_index_every=64, size_ratio=2)
    oracle, port, ref = RebuildOracle(pts), StreamingIndex(pts, **kw), RefStream(pts, **kw)
    n_ids = 600
    for n_ins, n_del in script:
        ins = _f32(rng.random((n_ins, 2)))
        np.testing.assert_array_equal(port.insert(ins), oracle.insert(ins))
        ref.insert(ins)
        n_ids += n_ins
        if n_del:
            dels = rng.integers(0, n_ids, size=n_del)
            assert port.delete(dels) == oracle.delete(dels) == ref.delete(dels)
        los = rng.random((2, 2)) * 0.7
        his = los + 0.25
        for a, b, c in zip(port.window(los, his), ref.window(los, his),
                           oracle.window(los, his)):
            np.testing.assert_array_equal(np.sort(a), c)
            np.testing.assert_array_equal(a, b)
        qs = _f32(rng.random((2, 2)))
        for a, b, c in zip(port.knn(qs, 6), ref.knn(qs, 6), oracle.knn(qs, 6)):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, c)
    _same_stream(ref, port)


def test_tier_retirement_recycles_pages():
    """Retired tiers hand their pages back to the store, so the allocator's
    high-water mark stays bounded under churn, as in the reference."""
    pts = f32_points(2000, 2, seed=1)
    kw = dict(delta_threshold=256, delta_index_every=64, size_ratio=2)
    s, ref = StreamingIndex(pts, **kw), RefStream(pts, **kw)
    rng = np.random.default_rng(1)
    live = list(range(2000))
    peak = s.store.allocated_pages
    for _ in range(40):
        batch = _f32(rng.random((256, 2)))
        ids = s.insert(batch)
        ref.insert(batch)
        live.extend(int(i) for i in ids)
        rng.shuffle(live)
        dead, live = live[:256], live[256:]
        s.delete(dead)
        ref.delete(dead)
        peak = max(peak, s.store.allocated_pages)
    assert s.merges >= 5 and s.store.free_page_count > 0
    need = -(-s.n_live // 341) * 4
    assert peak < need + 120, (peak, need)
    _same_stream(ref, s)


def test_mirror_rows_partition_live_tiers():
    pts = f32_points(1500, 2, seed=6)
    s = StreamingIndex(pts, delta_threshold=256, delta_index_every=64, size_ratio=2)
    mirror = DeviceMirror(s)
    rng = np.random.default_rng(6)
    for _ in range(12):
        s.insert(_f32(rng.random((200, 2))))
        s.delete(rng.integers(0, s.n_ids, size=20))
        mirror.sync()
        t = mirror.table
        seen, frontier = [], [0]
        while frontier:
            r = frontier.pop()
            if t.child_count[r] > 0:
                frontier.extend(range(t.first_child[r], t.first_child[r] + t.child_count[r]))
            elif t.leaf_count[r] > 0:
                seen.append(t.perm[t.leaf_start[r]:t.leaf_start[r] + t.leaf_count[r]])
        got = np.concatenate(seen)
        want = np.concatenate([tier.rows for tier in s.tiers])
        assert len(got) == len(np.unique(got))
        np.testing.assert_array_equal(np.sort(got), np.sort(want))


# --------------------------------------------------------------------------
# the card's export: delta-only, equal to a fresh export of the mirror
# --------------------------------------------------------------------------
def _same_as_fresh_export(dev, mirror, points):
    """The delta-grown export against a fresh ``from_table`` export of the
    mirror, slot for slot through ``leaf_rows``: counts, boxes (and bf16
    boxes) everywhere, points and ids in every live slot.  A retired leaf
    keeps its old block on the card behind a count of 0."""
    fresh = QT.DeviceTable.from_table(mirror.table, points, compressed=dev.compressed,
                                      device=CPU)
    assert sorted(dev.leaf_rows.tolist()) == sorted(fresh.leaf_rows.tolist())
    assert dev.n_points == fresh.n_points == dev.live_points()
    where = {int(r): j for j, r in enumerate(fresh.leaf_rows)}
    perm = np.array([where[int(r)] for r in dev.leaf_rows])
    cnt = dev.leaf_counts.numpy()
    assert np.array_equal(cnt, fresh.leaf_counts.numpy()[perm])
    for name in ("leaf_lo", "leaf_hi") + (("leaf_lo_c", "leaf_hi_c") if dev.compressed else ()):
        a, b = getattr(dev, name), getattr(fresh, name)[perm]
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b), name
    s = min(dev.leaf_size, fresh.leaf_size)
    assert int(cnt.max()) <= s
    live = np.arange(s)[None, :] < cnt[:, None]
    for name in ("leaf_pts", "leaf_ids"):
        a = getattr(dev, name)[:, :s].numpy()
        b = getattr(fresh, name)[perm][:, :s].numpy()
        assert np.array_equal(a[live], b[live]), name
    assert np.array_equal(dev.host_ids, dev.leaf_ids.numpy())
    return fresh


@pytest.mark.parametrize("compressed", [False, True])
def test_uploads_are_delta_only_and_equal_a_fresh_export(compressed):
    """Sustained ingest with rebuild-merges: one full export (the boot),
    one ``apply_delta`` per structural sync, every delta export equal to a
    fresh export of the mirror, no id twice in any answer although the
    retired tiers' blocks stay on the card, and answers equal to the
    reference server's and to the fresh export's."""
    pts = f32_points(3000, 2, seed=2)
    ref = StreamingServerEngine(pts, compressed=compressed)
    eng = PortServer(pts, compressed=compressed)
    srv, stream = eng.srv, eng.stream
    assert srv.upload_stats["full_exports"] == 1
    rng = np.random.default_rng(2)
    n_ids = 3000
    los = np.array([[0.1, 0.1], [0.5, 0.4], [0.0, 0.0]])
    his = los + np.array([[0.3, 0.3], [0.3, 0.3], [1.0, 1.0]])
    qs = f32_points(6, 2, seed=3)
    for _ in range(16):
        batch = _f32(rng.random((180, 2)))
        n_ids += len(eng.insert(batch))
        ref.insert(batch)
        dels = rng.integers(0, n_ids, size=10)
        eng.delete(dels)
        ref.delete(dels)
        assert not srv._stream_is_stale()
        fresh = _same_as_fresh_export(srv.dev, srv.mirror, stream.points)
        got = srv.window(los, his)
        for a, b in zip(got, ref.window(los, his)):
            assert len(a) == len(np.unique(a))
            np.testing.assert_array_equal(a, b)
        kn = srv.knn(qs, 12)
        for a, b in zip(kn, ref.knn(qs, 12)):
            assert len(a) == len(np.unique(a))
            np.testing.assert_array_equal(a, b)
        # the fresh export answers the same windows as the delta-grown one
        for a, b in zip(QT.window_query_batch_torch(srv.dev, los, his),
                        QT.window_query_batch_torch(fresh, los, his)):
            np.testing.assert_array_equal(np.sort(a), np.sort(b))
    assert stream.flushes >= 4 and stream.merges >= 1
    st, up = srv.stats, srv.upload_stats
    assert up["full_exports"] == 1
    assert up["delta_refreshes"] == st.delta_refreshes == st.stream_syncs
    assert st.delta_refreshes >= stream.flushes
    # retired rows stayed on the card behind a count of 0
    assert (srv.dev.leaf_counts.numpy() == 0).any()
    _same_server(ref.srv, srv)
    oracle = RebuildOracle(pts)
    rng2 = np.random.default_rng(2)
    for _ in range(16):
        oracle.insert(_f32(rng2.random((180, 2))))
        oracle.delete(rng2.integers(0, len(oracle.pts), size=10))
    for a, b in zip(srv.window(los, his), oracle.window(los, his)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(srv.knn(qs, 12), oracle.knn(qs, 12)):
        np.testing.assert_array_equal(a, b)


def test_knn_over_fetch_past_the_leaf_size():
    """k = 16 with 300 tombstones in the base tier over-fetches
    ``k_eff = 512`` rows, more than a leaf's 341 slots at d = 2: the fused
    k-NN, ``pair_dist2`` and the int32-key merge run at k > S on both
    exports, and the answers equal the reference's and the oracle's."""
    pts = f32_points(20_000, 2, seed=5)
    kw = dict(delta_threshold=2048, delta_index_every=256, size_ratio=4)
    rng = np.random.default_rng(17)
    dels = rng.choice(20_000, size=300, replace=False)
    qs = f32_points(24, 2, seed=6)
    qs[:8] = pts[dels[:8]]   # queries at deleted points
    oracle = RebuildOracle(pts)
    oracle.delete(dels)
    ins = _f32(rng.random((700, 2)))
    oracle.insert(ins)
    want = oracle.knn(qs, 16)
    ref = RefServer.from_streaming(RefStream(pts, **kw), microbatch=64)
    ref.delete(dels)
    ref.insert(ins)
    for compressed in (False, True):
        srv = DeviceQueryServer.from_streaming(StreamingIndex(pts, **kw), microbatch=64,
                                               compressed=compressed, device=CPU)
        srv.delete(dels)
        srv.insert(ins)
        assert srv.stream.shadow == 300 and len(srv.stream.delta_live_rows()) == 700
        assert srv._k_eff(16) == 512 > srv.dev.leaf_size == 341
        got = srv.knn(qs, 16)
        for i, (a, b, c) in enumerate(zip(got, ref.knn(qs, 16), want)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
            assert not np.isin(a, dels).any(), i
        # the device batch at k_eff itself: exact distances, no padding
        ids, d2 = QT.knn_query_batch_torch(srv.dev, qs, 512, return_dists=True)
        p32 = pts.astype(np.float32)
        for i in range(len(qs)):
            full = np.sort(np.sum((p32 - qs[i].astype(np.float32)) ** 2, axis=1))
            assert len(ids[i]) == 512 and (ids[i] >= 0).all()
            np.testing.assert_allclose(d2[i], full[:512], rtol=1e-6)


# --------------------------------------------------------------------------
# a failed upload: injected faults leave it stale, other errors propagate
# --------------------------------------------------------------------------
def test_stale_upload_serves_exact_then_converges():
    """Both attempts of the tier upload fault: queries fall back to the
    host stream (exact, intact certificates), and the next sync uploads
    again although it carries no new event; the counts equal the
    reference's."""
    pts = f32_points(1500, 2, seed=21)
    plans = (RefFaultPlan([RefFaultRule("apply_delta", rate=1.0, max_fires=2)], seed=0),
             FaultPlan([FaultRule("apply_delta", rate=1.0, max_fires=2)], seed=0))
    ref = StreamingServerEngine(pts, fault_plan=plans[0],
                                retry=RefRetryPolicy(max_attempts=2, sleep=lambda s: None))
    eng = PortServer(pts, fault_plan=plans[1],
                     retry=RetryPolicy(max_attempts=2, sleep=lambda s: None))
    oracle = PortHost(pts)
    rng = np.random.default_rng(21)
    batch = _f32(rng.random((600, 2)))
    for e in (ref, eng, oracle):
        e.insert(batch)
    assert eng.srv._stream_is_stale() and ref.srv._stream_device_stale
    los = np.array([[0.1, 0.1], [0.0, 0.0]])
    his = np.array([[0.6, 0.7], [1.0, 1.0]])
    res, certs = eng.srv.window(los, his, return_certs=True)
    assert all(c.complete for c in certs)
    ref.srv.window(los, his, return_certs=True)
    for a, b in zip(res, oracle.window(los, his)):
        np.testing.assert_array_equal(a, b)
    qs = _f32(rng.random((3, 2)))
    for a, b, c in zip(eng.knn(qs, 8), ref.knn(qs, 8), oracle.knn(qs, 8)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    small = _f32(rng.random((10, 2)))
    for e in (ref, eng, oracle):
        e.insert(small)
    assert not eng.srv._stream_is_stale()
    for a, b, c in zip(eng.window(los, his), ref.window(los, his), oracle.window(los, his)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    assert eng.srv.stats.retries == ref.srv.stats.retries == 1
    assert plans[1].fires_at("apply_delta") == plans[0].fires_at("apply_delta") == 2
    _same_server(ref.srv, eng.srv)


def test_upload_error_propagates_unretried(monkeypatch):
    """An upload error that is not an injected fault (a kernel that fails
    to launch, a CUDA error) reaches the inserter on its first attempt, as
    a ``StreamSyncError`` that says the op is committed and carries its
    ids; no
    query is then answered from the host or from the export that missed
    the sync, until a later sync lands it."""
    pts = f32_points(1500, 2, seed=22)
    eng = PortServer(pts)
    srv = eng.srv
    real = QT.DeviceTable.apply_delta

    def broken(*a, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(QT.DeviceTable, "apply_delta", broken)
    rng = np.random.default_rng(22)
    n_before = srv.stream.n_ids
    with pytest.raises(StreamSyncError, match="kernel launch failed") as e:
        eng.insert(_f32(rng.random((600, 2))))   # crosses the flush threshold
    # the op is committed: the error says so and carries the assigned ids
    assert e.value.op == "insert"
    np.testing.assert_array_equal(e.value.ids, np.arange(n_before, n_before + 600))
    np.testing.assert_array_equal(e.value.result, e.value.ids)
    assert "kernel launch failed" in str(e.value.__cause__)
    assert srv.stats.inserts == 600
    assert (srv.stats.retries, srv.stats.host_fallbacks, srv.stats.delta_refreshes) == (0, 0, 0)
    los, his = np.zeros((1, 2)), np.ones((1, 2))
    with pytest.raises(RuntimeError, match="missed a stream sync") as e:
        srv.window(los, his)
    assert "kernel launch failed" in str(e.value.__cause__)
    with pytest.raises(RuntimeError, match="missed a stream sync"):
        srv.knn(los, 3)
    with pytest.raises(StreamSyncError, match="kernel launch failed") as e:
        eng.delete([0, 1, 1])   # the stale export is re-sent, and fails again
    assert (e.value.op, e.value.result, srv.stats.deletes) == ("delete", 2, 2)
    np.testing.assert_array_equal(e.value.ids, [0, 1])
    monkeypatch.setattr(QT.DeviceTable, "apply_delta", real)
    eng.insert(_f32(rng.random((5, 2))))   # no new event: the sync re-uploads
    assert not srv._stream_is_stale()
    assert len(srv.window(los, his)[0]) == 2103
    assert srv.stats.inserts == 605
    assert srv.stats.retries == 0


# --------------------------------------------------------------------------
# races: the adaptive overlay's compaction under ingest
# --------------------------------------------------------------------------
def test_raced_ingest_adaptive_overlay_compaction():
    """Query threads drive adaptive refinement (and frequent compaction)
    while an ingest thread mutates the overlay; answers stay exact and,
    once quiet, equal the rebuild oracle's (the reference's
    ``test_raced_ingest_adaptive_overlay_compaction``)."""
    pts = f32_points(3000, 2, seed=13)
    n_base = len(pts)
    eng = PortOverlay(pts)
    eng.srv.compact_slack = 0.02
    pre_deleted = np.unique(np.random.default_rng(13).integers(0, n_base, size=80))
    eng.delete(pre_deleted)
    pre_set = set(int(i) for i in pre_deleted)
    stop, errors = threading.Event(), []

    def ingest():
        rng, mine = np.random.default_rng(99), []
        try:
            for _ in range(30):
                mine.extend(int(i) for i in eng.insert(_f32(rng.random((64, 2)))))
                if len(mine) > 128:
                    rng.shuffle(mine)
                    eng.delete(mine[:32])
                    mine = mine[32:]
        except Exception as e:  # noqa: BLE001 - recorded for the main thread
            errors.append(("ingest", e))
        finally:
            stop.set()

    def query(tseed):
        rng = np.random.default_rng(tseed)
        try:
            while not stop.is_set():
                lo = rng.random(2) * 0.6
                hi = lo + 0.3
                got = eng.window(lo, hi)[0]
                assert len(got) == len(np.unique(got))
                in_box = ((pts >= lo) & (pts <= hi)).all(axis=1)
                want = set(int(i) for i in np.flatnonzero(in_box)) - pre_set
                assert set(int(i) for i in got if i < n_base) == want
                r = eng.knn(rng.random(2), 8)[0]
                assert len(r) == len(np.unique(r)) <= 8
                assert not set(int(i) for i in r) & pre_set
        except Exception as e:  # noqa: BLE001
            errors.append((f"query-{tseed}", e))

    threads = [threading.Thread(target=ingest)] + [
        threading.Thread(target=query, args=(t,)) for t in (1, 2, 3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert eng.srv.stats.compactions > 0
    oracle = RebuildOracle(pts)
    oracle.delete(pre_deleted)
    rng, mine = np.random.default_rng(99), []
    for _ in range(30):
        mine.extend(int(i) for i in oracle.insert(_f32(rng.random((64, 2)))))
        if len(mine) > 128:
            rng.shuffle(mine)
            oracle.delete(mine[:32])
            mine = mine[32:]
    los = np.array([[0.05, 0.1], [0.4, 0.4], [0.0, 0.0]])
    his = los + np.array([[0.3, 0.3], [0.35, 0.3], [1.0, 1.0]])
    for a, b in zip(eng.window(los, his), oracle.window(los, his)):
        np.testing.assert_array_equal(np.sort(a), b)
    qs = f32_points(4, 2, seed=77)
    for a, b in zip(eng.knn(qs, 10), oracle.knn(qs, 10)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# stream snapshots: each package loads the other's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_stream_snapshot_roundtrip_across_packages(tmp_path, writer):
    pts = f32_points(1800, 2, seed=3)
    ref, port = RefStream(pts, **STREAM_KW), StreamingIndex(pts, **STREAM_KW)
    rng = np.random.default_rng(3)
    for _ in range(6):
        batch = _f32(rng.random((150, 2)))
        ref.insert(batch)
        port.insert(batch)
        dels = rng.integers(0, ref.n_ids, size=15)
        ref.delete(dels)
        port.delete(dels)
    assert ref.tiers and len(ref.delta_live_rows())
    path = tmp_path / "stream.npz"
    src, loader = (ref, StreamingIndex) if writer == "reference" else (port, RefStream)
    src.save(path, extra={"journal_seq": 41})
    assert StreamingIndex.is_stream_snapshot(path) and RefStream.is_stream_snapshot(path)
    loaded, meta = loader.load(path)
    assert int(meta["journal_seq"]) == 41
    _same_stream(src, loaded, counters=False)
    los = rng.random((3, 2)) * 0.6
    his = los + 0.25
    qs = _f32(rng.random((3, 2)))
    for a, b in zip(loaded.window(los, his), src.window(los, his)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(loaded.knn(qs, 6), src.knn(qs, 6)):
        np.testing.assert_array_equal(a, b)
    more = _f32(rng.random((600, 2)))   # both keep ingesting identically
    np.testing.assert_array_equal(loaded.insert(more), src.insert(more))
    for a, b in zip(loaded.window(los, his), src.window(los, his)):
        np.testing.assert_array_equal(a, b)
    _same_stream(src, loaded, counters=False)
