"""Sharded serving of the PyTorch port against the JAX package's:
``DeviceQueryServer(shards=m)``, static, adaptive over AMBI and streaming,
with its resilience plane, and ``recover`` with ``shards=``.

The reference's sharded scenarios (``tests/test_distributed_jax.py``,
``test_adaptive_serve.py``, ``test_chaos.py``, ``test_faults.py`` and
``test_streaming.py``) run through ``repro.serve.engine.DeviceQueryServer``
(JAX on the CPU) and through the port's twin with ``device="cpu"``, where
every kernel runs as its plain version.  Points are float32-representable
(``engines.f32_points``).  Contract:

  * windows: equal id sets, equal to the NumPy oracle;
  * k-NN: equal f64 distance sequences, equal to a brute force, equal ids
    where the oracle's k-th distance is strictly below its (k+1)-th (the
    streaming contract ranks by f64 distance, ties by id: equal ids);
  * equal certificates, ``DeviceQueryStats`` and ``upload_stats``.

Every scenario here is a fixed seed; the fault schedules are pure
functions of their seeds and the dispatch sequence, so equal counters
also say that both packages dispatched alike.
"""
import dataclasses
import re
import threading

import numpy as np
import pytest

from repro.core import AMBI as RefAMBI
from repro.core.distributed_jax import ShardUnavailable as RefShardUnavailable
from repro.serve.engine import DeviceQueryServer as RefServer
from repro.serve.faults import FaultPlan as RefFaultPlan
from repro.serve.faults import FaultRule as RefFaultRule
from repro.serve.frontend import VirtualClock as RefClock
from repro.serve.resilience import DeadlineExceeded as RefDeadlineExceeded
from repro.serve.resilience import RetryPolicy as RefRetryPolicy
from repro_torch.core import AMBI, NodeTable, PageStore, StreamingIndex, bulk_load
from repro_torch.core import distributed_torch as DT
from repro_torch.core import queries_torch as QT
from repro_torch.core.distributed_torch import ShardUnavailable
from repro_torch.core.queries import knn_oracle, window_oracle
from repro_torch.serve import (
    DeviceQueryServer,
    FaultPlan,
    FaultRule,
    RetryPolicy,
    StreamSyncError,
    VirtualClock,
)
from repro_torch.serve.resilience import DeadlineExceeded

from engines import (
    STREAM_KW,
    RebuildOracle,
    StreamingServerEngine,
    assert_degraded_knn,
    assert_degraded_window,
    build_fmbi,
    f32_points,
    shard_owned_ids,
)

CPU = "cpu"


def _f32(a):
    return np.asarray(a, dtype=np.float32).astype(np.float64)


def _pair(pts, M=250):
    return build_fmbi(pts, M), bulk_load(pts, M, PageStore(M))


def _same_stats(ref, port):
    """Equal serving counters and upload counters."""
    assert dataclasses.asdict(ref.stats) == dataclasses.asdict(port.stats)
    assert ref.upload_stats.as_dict() == port.upload_stats.as_dict()


def _same_certs(ref_certs, port_certs):
    assert len(ref_certs) == len(port_certs)
    for a, b in zip(ref_certs, port_certs):
        assert (a.complete, a.certified_exact, a.missing_shards) == (
            b.complete, b.certified_exact, b.missing_shards)
        for x, y in ((a.missing_lo, b.missing_lo), (a.missing_hi, b.missing_hi)):
            assert (x is None and y is None) or np.array_equal(x, y)


def _check_windows(pts, los, his, got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(np.sort(g), np.sort(w)), i
        assert np.array_equal(np.sort(g), window_oracle(pts, los[i], his[i])), i


def _check_knn(pts, qs, k, got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        dg = np.sum((pts[g] - qs[i]) ** 2, axis=1)
        dw = np.sum((pts[w] - qs[i]) ** 2, axis=1)
        assert np.array_equal(dg, dw), i
        full = np.sort(np.sum((pts - qs[i]) ** 2, axis=1))
        assert np.array_equal(np.sort(dg), full[: len(dg)]), i
        if len(full) > k and full[k - 1] < full[k]:
            assert set(g.tolist()) == set(knn_oracle(pts, qs[i], k).tolist()), i


def _no_sleep(attempts, ref=False):
    return (RefRetryPolicy if ref else RetryPolicy)(max_attempts=attempts,
                                                    sleep=lambda s: None)


# --------------------------------------------------------------------------
# static sharded serving
# --------------------------------------------------------------------------
def test_device_server_sharded_mode():
    pts = f32_points(6000, 2, 21)
    ref_idx, idx = _pair(pts)
    ref4 = RefServer.from_index(ref_idx, microbatch=32, shards=4)
    srv1 = DeviceQueryServer.from_index(idx, microbatch=32, device=CPU)
    srv4 = DeviceQueryServer.from_index(idx, microbatch=32, shards=4, device=CPU)
    assert srv4.stats.shards == 4 and srv1.stats.shards == 1
    assert srv4.dev is None and srv4.sdev.device.type == "cpu"
    assert srv4.sdev.shard_roots == ref4.sdev.shard_roots
    rng = np.random.default_rng(22)
    centers = _f32(rng.random((80, 2)))
    los, his = centers - 0.04, centers + 0.04
    w1, w4 = srv1.window(los, his), srv4.window(los, his)
    _check_windows(pts, los, his, w4, w1)
    _check_windows(pts, los, his, w4, ref4.window(los, his))
    k1, k4 = srv1.knn(centers[:40], 8), srv4.knn(centers[:40], 8)
    for a, b in zip(k1, k4):
        assert np.array_equal(a, b)
    _check_knn(pts, centers[:40], 8, k4, ref4.knn(centers[:40], 8))
    assert srv4.stats.microbatches == 3 + 2  # ceil(80/32) + ceil(40/32)
    assert srv4.stats.queries == 120
    _same_stats(ref4, srv4)
    assert srv4.upload_stats["full_exports"] == 4


# --------------------------------------------------------------------------
# sharded adaptive serving: targeted refreshes, the re-plan
# --------------------------------------------------------------------------
def _adaptive_pair(pts, M, shards, pre=None, **kw):
    ref_ambi, ambi = RefAMBI(pts, M), AMBI(pts, M)
    if pre is not None:
        for a in (ref_ambi, ambi):  # give the root children so the plan can split
            a.window(*pre)
    ref = RefServer.from_ambi(ref_ambi, shards=shards, **kw)
    port = DeviceQueryServer.from_ambi(ambi, shards=shards, device=CPU, **kw)
    return ref, port


def _same_adaptive(ref, port):
    _same_stats(ref, port)
    for c in NodeTable.COLUMNS:
        assert np.array_equal(getattr(ref.ambi.table, c), getattr(port.ambi.table, c)), c
    assert port.sdev.shard_roots == ref.sdev.shard_roots
    assert np.array_equal(port.sdev.shard_lo, ref.sdev.shard_lo)


def test_sharded_adaptive_refreshes_only_changed_shards():
    pts = f32_points(100_000, 2, 10)
    host = AMBI(pts, 120)
    host.window(np.full(2, 0.4), np.full(2, 0.45))
    ref, srv = _adaptive_pair(pts, 120, 4, pre=(np.full(2, 0.4), np.full(2, 0.45)),
                              microbatch=8)
    m = srv.sdev.m
    boot = srv.upload_stats["full_exports"]
    assert boot == m == 4
    rng = np.random.default_rng(11)
    for step in range(4):
        c = _f32(rng.random((8, 2)) * 0.3 + 0.3)
        got = srv.window(c - 0.02, c + 0.02)
        rw = ref.window(c - 0.02, c + 0.02)
        for i in range(8):
            want, _ = host.window(c[i] - 0.02, c[i] + 0.02)
            assert np.array_equal(np.sort(got[i]), np.sort(want)), (step, i)
            assert np.array_equal(np.sort(got[i]), np.sort(rw[i])), (step, i)
        gk = srv.knn(c, 8)
        _check_knn(pts, c, 8, gk, ref.knn(c, 8))
        for i in range(8):
            wk, _ = host.knn(c[i], 8)
            assert np.array_equal(gk[i], wk), (step, i)
        _same_adaptive(ref, srv)
    extra = srv.upload_stats["full_exports"] - boot
    assert extra == srv.stats.shard_refreshes > 0
    assert extra < m * srv.stats.microbatches
    srv.ambi.table.check_invariants(len(pts))


def test_sharded_adaptive_unrefined_root_boot_replans_to_m_shards():
    """From the single unrefined root the plan is one whole-table shard;
    the server re-plans to the requested count once grafts allow, and
    refreshes only changed shards after that."""
    pts = f32_points(80_000, 2, 20)
    host = AMBI(pts, 120)
    ref, srv = _adaptive_pair(pts, 120, 3, microbatch=8)
    assert srv.sdev.m == 1 and srv.stats.shards == 1
    rng = np.random.default_rng(21)
    for step in range(4):
        c = _f32(rng.random((8, 2)) * 0.3 + 0.3)
        got = srv.window(c - 0.02, c + 0.02)
        ref.window(c - 0.02, c + 0.02)
        for i in range(8):
            want, _ = host.window(c[i] - 0.02, c[i] + 0.02)
            assert np.array_equal(np.sort(got[i]), np.sort(want)), (step, i)
        _same_adaptive(ref, srv)
    assert srv.sdev.m == 3 and srv.stats.shards == 3
    assert srv.upload_stats["full_exports"] == (
        1 + srv.sdev.m + (srv.stats.shard_refreshes - srv.sdev.m))


def test_sharded_adaptive_compaction_and_brownout():
    """Compaction at ``compact_slack=0`` rebases the shard plan
    (``remap_source_rows``), and the brownout tier's sharded answers and
    certificates equal the reference's."""
    pts = f32_points(60_000, 2, 12)
    ref, srv = _adaptive_pair(pts, 100, 2, pre=(np.full(2, 0.2), np.full(2, 0.25)),
                              microbatch=4, compact_slack=0.0)
    rng = np.random.default_rng(13)
    for _ in range(4):
        c = _f32(rng.random((4, 2)) * 0.7 + 0.15)
        _check_windows(pts, c - 0.03, c + 0.03, srv.window(c - 0.03, c + 0.03),
                       ref.window(c - 0.03, c + 0.03))
        _check_knn(pts, c, 6, srv.knn(c, 6), ref.knn(c, 6))
    assert srv.stats.compactions >= 1
    _same_adaptive(ref, srv)
    qs = _f32(rng.random((24, 2)))
    los, his = qs - 0.01, qs + 0.01
    (rw, rwc), (pw, pwc) = ref.window_hot(los, his), srv.window_hot(los, his)
    (rk, rkc), (pk, pkc) = ref.knn_hot(qs, 8), srv.knn_hot(qs, 8)
    for i in range(len(qs)):
        assert np.array_equal(np.sort(rw[i]), np.sort(pw[i]))
        assert np.array_equal(rk[i], pk[i])
    _same_certs(rwc + rkc, pwc + pkc)
    cold = srv.cold_window_mask(los, his)
    assert 0 < cold.sum() < len(qs)
    assert [not c.complete for c in pwc] == cold.tolist()
    _same_adaptive(ref, srv)


# --------------------------------------------------------------------------
# chaos: bounded storms absorbed, dead shards certified, repair
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def chaos():
    pts = f32_points(900, 2, seed=21)
    ref_idx, idx = _pair(pts, M=64)
    rng = np.random.default_rng(4)
    c = rng.random((16, 2))
    los, his = np.clip(c - 0.15, 0, 1), np.clip(c + 0.15, 0, 1)
    qs = rng.random((16, 2))
    return pts, ref_idx, idx, los, his, qs


@pytest.mark.parametrize("shards", [2, 4])
def test_chaos_parity_under_bounded_storm(chaos, shards):
    pts, ref_idx, idx, los, his, qs = chaos
    plans = (RefFaultPlan.storm(("shard_dispatch",), 0.4, seed=1337, max_fires_per_point=3),
             FaultPlan.storm(("shard_dispatch",), 0.4, seed=1337, max_fires_per_point=3))
    ref = RefServer.from_index(ref_idx, shards=shards, microbatch=8, fault_plan=plans[0],
                               retry=_no_sleep(5, ref=True))
    srv = DeviceQueryServer.from_index(idx, shards=shards, microbatch=8, fault_plan=plans[1],
                                       retry=_no_sleep(5), device=CPU)
    _check_windows(pts, los, his, srv.window(los, his), ref.window(los, his))
    _check_knn(pts, qs, 5, srv.knn(qs, 5), ref.knn(qs, 5))
    assert plans[1].total_fires == plans[0].total_fires > 0
    assert srv.stats.retries > 0 and srv.stats.degraded_queries == 0
    _same_stats(ref, srv)


@pytest.fixture(scope="module")
def dead_shard(chaos):
    pts, ref_idx, idx, los, his, qs = chaos
    dead = 2
    kw = dict(shards=4, microbatch=8, breaker_threshold=1, breaker_cooldown_s=1e9)
    ref = RefServer.from_index(
        ref_idx, fault_plan=RefFaultPlan([RefFaultRule("shard_dispatch", rate=1.0,
                                                       match={"shard": dead})], seed=1337),
        retry=_no_sleep(2, ref=True), **kw)
    plan = FaultPlan([FaultRule("shard_dispatch", rate=1.0, match={"shard": dead})],
                     seed=1337)
    srv = DeviceQueryServer.from_index(idx, fault_plan=plan, retry=_no_sleep(2),
                                       device=CPU, **kw)
    owned = shard_owned_ids(srv.sdev, dead)
    assert owned and owned == shard_owned_ids(ref.sdev, dead)
    return pts, idx, ref, srv, plan, dead, owned


def test_chaos_dead_shard_window_certificates(chaos, dead_shard):
    pts, idx, ref, srv, plan, dead, owned = dead_shard
    _, _, _, los, his, _ = chaos
    got, certs = srv.window(los, his, return_certs=True)
    rgot, rcerts = ref.window(los, his, return_certs=True)
    n_degraded = 0
    for i in range(len(los)):
        cert = certs[i]
        if not cert.complete:
            n_degraded += 1
            assert cert.missing_shards == (dead,) and not cert.certified_exact
        assert_degraded_window(pts, los[i], his[i], got[i], cert,
                               window_oracle(pts, los[i], his[i]), owned)
        assert np.array_equal(np.sort(got[i]), np.sort(rgot[i]))
    _same_certs(rcerts, certs)
    assert 0 < n_degraded < len(los)
    assert srv.stats.degraded_queries == n_degraded


def test_chaos_dead_shard_knn_certificates(chaos, dead_shard):
    pts, idx, ref, srv, plan, dead, owned = dead_shard
    *_, qs = chaos
    k = 5
    got, certs = srv.knn(qs, k, return_certs=True)
    rgot, rcerts = ref.knn(qs, k, return_certs=True)
    n_exact = n_partial = 0
    for i in range(len(qs)):
        cert = certs[i]
        if cert.certified_exact:
            n_exact += 1
        elif not cert.complete:
            n_partial += 1
            assert cert.missing_shards == (dead,)
        assert_degraded_knn(pts, qs[i], k, got[i], cert, knn_oracle(pts, qs[i], k), owned)
        assert np.array_equal(got[i], rgot[i])
    _same_certs(rcerts, certs)
    assert n_exact > 0 and n_partial > 0


def test_chaos_repair_restores_full_parity(chaos, dead_shard):
    pts, idx, ref, srv, plan, dead, owned = dead_shard
    _, _, _, los, his, qs = chaos
    assert srv.breakers[dead].state == "open"
    before, exports = srv.stats.shard_refreshes, srv.upload_stats["full_exports"]
    plan.disarm()
    ref.fault_plan.disarm()
    assert srv.repair() == [dead] == ref.repair()
    assert srv.stats.shard_refreshes == before + 1
    assert srv.upload_stats["full_exports"] == exports + 1
    assert srv.breakers[dead].state == "closed"
    got, certs = srv.window(los, his, return_certs=True)
    assert all(c.complete for c in certs)
    _check_windows(pts, los, his, got, ref.window(los, his))
    _check_knn(pts, qs, 5, srv.knn(qs, 5), ref.knn(qs, 5))
    _same_stats(ref, srv)


# --------------------------------------------------------------------------
# faults (the reference's test_faults.py, sharded)
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def static_setup():
    pts = f32_points(700, 2, seed=5)
    ref_idx, idx = _pair(pts, M=64)
    rng = np.random.default_rng(2)
    c = rng.random((12, 2))
    return pts, ref_idx, idx, np.clip(c - 0.12, 0, 1), np.clip(c + 0.12, 0, 1), \
        rng.random((12, 2))


def test_server_absorbs_bounded_faults(static_setup):
    pts, ref_idx, idx, los, his, qs = static_setup
    plans = (RefFaultPlan([RefFaultRule("shard_dispatch", at_calls={1, 3})], seed=0),
             FaultPlan([FaultRule("shard_dispatch", at_calls={1, 3})], seed=0))
    ref = RefServer.from_index(ref_idx, shards=2, fault_plan=plans[0], microbatch=8)
    srv = DeviceQueryServer.from_index(idx, shards=2, fault_plan=plans[1], microbatch=8,
                                       device=CPU)
    srv.retry.sleep = ref.retry.sleep = lambda s: None
    _check_windows(pts, los, his, srv.window(los, his), ref.window(los, his))
    _check_knn(pts, qs, 5, srv.knn(qs, 5), ref.knn(qs, 5))
    assert plans[1].total_fires == plans[0].total_fires == 2
    assert srv.stats.retries >= 2
    _same_stats(ref, srv)


def test_deadline_exceeded_surfaces(static_setup):
    pts, ref_idx, idx, los, his, qs = static_setup
    for Server, Clock, Exc, kw in (
            (RefServer, RefClock, RefDeadlineExceeded, {}),
            (DeviceQueryServer, VirtualClock, DeadlineExceeded, {"device": CPU})):
        clk = Clock()
        srv = Server.from_index(ref_idx if Server is RefServer else idx, shards=2,
                                deadline_s=5.0, clock=clk, microbatch=8, **kw)
        clk.t = 0.0
        assert len(srv.window(los[:2], his[:2])) == 2   # within budget
        orig = srv._deadline

        def slow(orig=orig, clk=clk):
            dl = orig()
            clk.t += 10.0   # the batch budget is spent before dispatch
            return dl

        srv._deadline = slow
        with pytest.raises(Exc):
            srv.window(los[:2], his[:2])


def test_breaker_opens_degrades_and_repairs(static_setup):
    pts, ref_idx, idx, los, his, qs = static_setup
    servers = []
    for Server, Plan, Rule, Clock, Unavailable, kw in (
            (RefServer, RefFaultPlan, RefFaultRule, RefClock, RefShardUnavailable, {}),
            (DeviceQueryServer, FaultPlan, FaultRule, VirtualClock, ShardUnavailable,
             {"device": CPU})):
        plan = Plan([Rule("shard_dispatch", rate=1.0, match={"shard": 1})], seed=0)
        srv = Server.from_index(
            ref_idx if Server is RefServer else idx, shards=2, fault_plan=plan,
            microbatch=32, retry=_no_sleep(2, ref=Server is RefServer),
            breaker_threshold=1, breaker_cooldown_s=1e9, clock=Clock(), **kw)
        full_lo, full_hi = np.zeros((1, 2)), np.ones((1, 2))
        with pytest.raises(Unavailable):
            srv.window(full_lo, full_hi)
        res, certs = srv.window(full_lo, full_hi, return_certs=True)
        assert not certs[0].complete and certs[0].missing_shards == (1,)
        assert srv.breakers[1].state == "open" and srv.stats.degraded_queries >= 1
        fires = plan.total_fires
        degraded = srv.window(full_lo, full_hi, return_certs=True)   # breaker: fail fast
        assert plan.total_fires == fires
        plan.disarm()
        assert srv.repair() == [1] and srv.breakers[1].state == "closed"
        healed, hcerts = srv.window(full_lo, full_hi, return_certs=True)
        assert hcerts[0].complete
        assert np.array_equal(np.sort(healed[0]), np.arange(len(pts)))
        servers.append((srv, res, certs, degraded))
    (ref, rres, rcerts, rdeg), (srv, pres, pcerts, pdeg) = servers
    assert np.array_equal(np.sort(rres[0]), np.sort(pres[0]))
    _same_certs(rcerts + rdeg[1], pcerts + pdeg[1])
    _same_stats(ref, srv)


# --------------------------------------------------------------------------
# sharded streaming serving
# --------------------------------------------------------------------------
class PortStreamServer:
    def __init__(self, pts, shards=None, **server_kw):
        self.pts = np.asarray(pts, np.float64)
        self.stream = StreamingIndex(self.pts, **STREAM_KW)
        self.srv = DeviceQueryServer.from_streaming(self.stream, microbatch=32,
                                                    shards=shards, device=CPU, **server_kw)
        self.name = f"port-stream-server[m={shards or 1}]"

    def insert(self, pts):
        return self.srv.insert(pts)

    def delete(self, ids):
        return self.srv.delete(ids)

    def window(self, los, his):
        return self.srv.window(np.atleast_2d(los), np.atleast_2d(his))

    def knn(self, qs, k):
        return self.srv.knn(np.atleast_2d(qs), k)


def _same_stream_server(ref, port):
    _same_stats(ref, port)
    for c in NodeTable.COLUMNS:
        assert np.array_equal(getattr(ref.mirror.table, c), getattr(port.mirror.table, c)), c
    assert port.sdev.shard_roots == ref.sdev.shard_roots
    for s in range(port.sdev.m):
        assert np.array_equal(port.sdev.shards[s].host_ids,
                              np.asarray(ref.sdev.shards[s].leaf_ids))


def _drive(engines, seed, steps, max_ins=150, check_every=3, on_check=None):
    """The reference's interleaving schedule: one insert/delete sequence on
    every engine, answers held against ``engines[0]`` at checkpoints."""
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


def test_engine_matrix_interleaving_sharded():
    """The reference's engine matrix with its sharded streaming server at
    m = 3, beside the port's: answers equal the rebuild oracle's, and the
    mirror tables, shard plans, shard exports and counters equal."""
    pts = f32_points(3000, 2, seed=7)
    ref = StreamingServerEngine(pts, shards=3)
    port = PortStreamServer(pts, shards=3)
    _drive([RebuildOracle(pts), ref, port], seed=7, steps=14,
           on_check=lambda: _same_stream_server(ref.srv, port.srv))
    assert port.srv.stats.stream_reshards == 0
    assert port.srv.stats.shard_refreshes > 0


def test_sharded_refresh_avoids_full_reshard():
    """Shard surgery absorbs tier attach, fuse and retire without a full
    re-shard; only the shards whose plan rows changed are re-exported."""
    pts = f32_points(4000, 2, seed=9)
    ref, port = StreamingServerEngine(pts, shards=3), PortStreamServer(pts, shards=3)
    rng = np.random.default_rng(9)
    n_ids = 4000
    for step in range(20):
        batch = _f32(rng.random((150, 2)))
        n_ids += len(port.insert(batch))
        ref.insert(batch)
        if step % 3 == 0:
            dels = rng.integers(0, n_ids, size=25)
            assert port.delete(dels) == ref.delete(dels)
    st_ = port.srv.stats
    assert st_.stream_syncs >= 3 and st_.stream_reshards == 0
    assert 0 < st_.shard_refreshes < 3 * st_.stream_syncs
    assert port.srv.upload_stats["full_exports"] == 3 + st_.shard_refreshes
    _same_stream_server(ref.srv, port.srv)


def test_raced_ingest_streaming_server_sharded():
    """Query threads read while an ingest thread inserts and deletes
    (the reference's ``_raced`` on the port's sharded streaming server)."""
    pts = f32_points(3000, 2, seed=13)
    n_base = len(pts)
    eng = PortStreamServer(pts, shards=3)
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
    assert eng.srv.stats.stream_reshards == 0


def test_streaming_sharded_outage_returns_degraded_certificates():
    """A dead shard on the sharded streaming path degrades through the
    certificates (the reference's ``:562``), equal to the reference's."""
    pts = f32_points(2000, 2, seed=11)
    ref = StreamingServerEngine(
        pts, shards=3, retry=_no_sleep(2, ref=True),
        fault_plan=RefFaultPlan([RefFaultRule("shard_dispatch", rate=1.0,
                                              match={"shard": 1})], seed=0))
    port = PortStreamServer(
        pts, shards=3, retry=_no_sleep(2),
        fault_plan=FaultPlan([FaultRule("shard_dispatch", rate=1.0, match={"shard": 1})],
                             seed=0))
    host = StreamingIndex(pts, **STREAM_KW)
    los = np.array([[0.0, 0.0], [0.2, 0.1]])
    his = np.array([[1.0, 1.0], [0.8, 0.9]])
    res, certs = port.srv.window(los, his, return_certs=True)
    rres, rcerts = ref.srv.window(los, his, return_certs=True)
    assert any(not c.complete for c in certs)
    for a, b, c in zip(res, host.window(los, his), rres):
        assert np.isin(a, b).all()
        assert np.array_equal(np.sort(a), np.sort(c))
    _same_certs(rcerts, certs)
    qs = f32_points(2, 2, seed=12)
    res, certs = port.srv.knn(qs, 5, return_certs=True)
    rres, rcerts = ref.srv.knn(qs, 5, return_certs=True)
    assert len(res) == len(certs) == len(qs)
    for a, b in zip(res, rres):
        assert np.array_equal(a, b)
    _same_certs(rcerts, certs)
    _same_stats(ref.srv, port.srv)


def test_sharded_stale_refresh_serves_exact_then_converges():
    """Both attempts of a sharded sync's upload fault: queries answer from
    the host stream (exact), and the next sync, although it carries no new
    event, applies the missed plan surgery and lands the flushed tier.
    The reference drops the missed sync's summary here and leaves the 600
    flushed rows out of every later answer (ROADMAP C.6)."""
    pts = f32_points(1500, 2, seed=21)
    plan = FaultPlan([FaultRule("apply_delta", rate=1.0, max_fires=2)], seed=0)
    port = PortStreamServer(pts, shards=3, fault_plan=plan, retry=_no_sleep(2))
    host = StreamingIndex(pts, **STREAM_KW)
    rng = np.random.default_rng(21)
    los = np.array([[0.1, 0.1], [0.0, 0.0]])
    his = np.array([[0.6, 0.7], [1.0, 1.0]])
    for step, n in enumerate((600, 10, 700)):
        batch = _f32(rng.random((n, 2)))
        port.insert(batch)
        host.insert(batch)
        assert port.srv._stream_is_stale() == (step == 0)
        assert len(port.srv._stream_pending_syncs) == (step == 0)
        res, certs = port.srv.window(los, his, return_certs=True)
        assert all(c.complete for c in certs)
        for a, c in zip(res, host.window(los, his)):
            np.testing.assert_array_equal(a, c)
        qs = _f32(rng.random((3, 2)))
        for a, c in zip(port.knn(qs, 8), host.knn(qs, 8)):
            np.testing.assert_array_equal(a, c)
    st_ = port.srv.stats
    assert (st_.retries, st_.stream_syncs, st_.host_fallbacks) == (1, 3, 0)
    assert plan.fires_at("apply_delta") == 2
    assert port.srv.upload_stats["full_exports"] == 3 + st_.shard_refreshes


def test_sharded_streaming_server_recovers_with_shards(tmp_path):
    """A journaled sharded streaming server, killed after a barrier and
    more ingest, recovers with ``shards=3`` and answers as the live one."""
    pts = f32_points(2000, 2, seed=8)
    live = PortStreamServer(pts, shards=3, journal_path=tmp_path / "ops.journal",
                            snapshot_path=tmp_path / "snap.npz")
    rng = np.random.default_rng(8)
    for r in range(7):
        ids = live.insert(_f32(rng.random((90, 2))))
        live.delete(rng.integers(0, int(ids[-1]) + 1, size=12))
        if r == 3:
            live.srv.checkpoint()
    rec = DeviceQueryServer.recover(tmp_path / "snap.npz", tmp_path / "ops.journal",
                                    microbatch=32, shards=3, device=CPU)
    assert rec.sdev is not None and rec.stats.shards == rec.sdev.m == 3
    assert rec.stats.replayed_records == 6
    np.testing.assert_array_equal(rec.stream.live_ids(), live.stream.live_ids())
    los = np.array([[0.1, 0.2], [0.0, 0.0]])
    his = np.array([[0.45, 0.55], [1.0, 1.0]])
    for a, b in zip(rec.window(los, his), live.window(los, his)):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))
    qs = f32_points(3, 2, seed=5)
    for a, b in zip(rec.knn(qs, 9), live.knn(qs, 9)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# errors that are not injected faults propagate, unretried
# --------------------------------------------------------------------------
def _broken(*a, **kw):
    raise RuntimeError("kernel launch failed")


@pytest.mark.parametrize("stage", ["window", "knn", "adaptive_window", "refresh"])
def test_device_errors_propagate_unretried(stage, monkeypatch):
    """A device error in a sharded dispatch or a shard refresh reaches the
    caller on its first attempt: no retry, no host fallback, no degraded
    answer, every breaker closed."""
    pts = f32_points(60_000, 2, 22)
    if stage in ("window", "knn"):
        srv = DeviceQueryServer.from_index(bulk_load(pts, 250, PageStore(250)), shards=3,
                                           microbatch=8, device=CPU)
    else:
        ambi = AMBI(pts, 120)
        ambi.window(np.full(2, 0.1), np.full(2, 0.12))
        srv = DeviceQueryServer.from_ambi(ambi, shards=3, microbatch=8, device=CPU)
        assert srv.sdev.m == 3 and ambi.table.unrefined.any()
    target = {"window": (DT, "window_query_batch_torch"),
              "knn": (DT, "knn_query_batch_torch"),
              "adaptive_window": (DT, "window_query_batch_torch"),
              "refresh": (QT.DeviceTable, "from_table")}[stage]
    monkeypatch.setattr(*target, _broken)
    # hot windows inside the refined corner, cold ones elsewhere
    corner = 0.1 if stage == "adaptive_window" else 0.4
    qs = _f32(np.random.default_rng(23).random((8, 2)) * 0.01 + corner + 0.005)
    if stage == "adaptive_window":
        assert not srv.cold_window_mask(qs - 0.001, qs + 0.001).any()
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        if stage == "knn":
            srv.knn(qs, 4)
        else:
            srv.window(qs - 0.001, qs + 0.001)
    s = srv.stats
    assert (s.retries, s.host_fallbacks, s.degraded_queries) == (0, 0, 0)
    assert all(br.state == "closed" for br in srv.breakers.values())


def test_stream_sync_error_propagates_unretried(monkeypatch):
    """A non-fault error while a sharded sync re-exports its shards reaches
    the inserter as a ``StreamSyncError`` (the op is committed); queries
    raise instead of being served from the host, and the next sync
    re-exports the shards the failed one left behind."""
    pts = f32_points(1500, 2, seed=22)
    eng = PortStreamServer(pts, shards=3)
    srv = eng.srv
    oracle = RebuildOracle(pts)
    real = QT.DeviceTable.from_table
    monkeypatch.setattr(QT.DeviceTable, "from_table", _broken)
    rng = np.random.default_rng(22)
    batch = _f32(rng.random((600, 2)))     # crosses the flush threshold
    oracle.insert(batch)
    with pytest.raises(StreamSyncError, match="kernel launch failed") as e:
        eng.insert(batch)
    assert e.value.op == "insert" and len(e.value.ids) == 600
    assert srv.stats.inserts == 600 and srv._stream_stale_shards
    assert (srv.stats.retries, srv.stats.host_fallbacks, srv.stats.shard_refreshes) == (
        0, 0, 0)
    los, his = np.zeros((1, 2)), np.ones((1, 2))
    for call in (lambda: srv.window(los, his), lambda: srv.knn(los, 3)):
        with pytest.raises(RuntimeError, match="missed a stream sync") as e:
            call()
        assert "kernel launch failed" in str(e.value.__cause__)
    monkeypatch.setattr(QT.DeviceTable, "from_table", real)
    small = _f32(rng.random((5, 2)))      # no new event: the sync re-exports
    oracle.insert(small)
    eng.insert(small)
    assert not srv._stream_is_stale() and srv.stats.shard_refreshes > 0
    np.testing.assert_array_equal(srv.window(los, his)[0], oracle.window(los, his)[0])
    qs = _f32(rng.random((3, 2)))
    for a, b in zip(srv.knn(qs, 8), oracle.knn(qs, 8)):
        np.testing.assert_array_equal(a, b)
    assert srv.stats.retries == 0 and srv.stats.stream_reshards == 0


def test_repair_lands_a_failed_sharded_sync(monkeypatch):
    """After a non-fault sync error, ``repair`` of the shards it left
    behind lands the export, and queries answer again."""
    pts = f32_points(1500, 2, seed=24)
    eng = PortStreamServer(pts, shards=3)
    srv = eng.srv
    real = QT.DeviceTable.from_table
    monkeypatch.setattr(QT.DeviceTable, "from_table", _broken)
    batch = _f32(np.random.default_rng(24).random((600, 2)))
    with pytest.raises(StreamSyncError):
        eng.insert(batch)
    stale = sorted(srv._stream_stale_shards)
    with pytest.raises(RuntimeError, match=re.escape(f"repair({stale})")):
        srv.window(np.zeros((1, 2)), np.ones((1, 2)))
    monkeypatch.setattr(QT.DeviceTable, "from_table", real)
    assert srv.repair(stale) == stale
    assert not srv._stream_is_stale()
    got = srv.window(np.zeros((1, 2)), np.ones((1, 2)))[0]
    np.testing.assert_array_equal(got, np.arange(2100))
