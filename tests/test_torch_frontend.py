"""The async frontend of the PyTorch port against the JAX package's:
admission, batching, shedding and brownout in front of the port's
``DeviceQueryServer`` (``device="cpu"``).

The reference's scenarios (``tests/test_frontend.py`` and the two
single-device chaos scenarios of ``tests/test_chaos.py``) run on the port;
where the reference's frontend can run the same schedule, both run it and
every request's status, reason, ids, brownout flag and completion time,
and the frontend's counters, are equal.  Admitted answers equal the NumPy
oracle.  One departure is tested on purpose: an error that is not an
injected fault, in a dispatch or a refinement, is neither retried nor
shed — its requests end in ``error`` and the caller sees it.
"""
import threading

import numpy as np
import pytest

from repro.core import PageStore as RefPageStore
from repro.core import bulk_load as ref_bulk_load
from repro.serve.engine import DeviceQueryServer as RefServer
from repro.serve.frontend import Frontend as RefFrontend
from repro.serve.frontend import VirtualClock as RefClock
from repro_torch.core import AMBI, PageStore, StreamingIndex, bulk_load
from repro_torch.core.queries import knn_query_batch, window_query_batch
from repro_torch.serve import (
    DeviceQueryServer,
    FaultPlan,
    FaultRule,
    Frontend,
    RetryPolicy,
    VirtualClock,
)

from engines import STREAM_KW, f32_points

CPU = "cpu"
K = 5


@pytest.fixture(scope="module")
def setup():
    pts = f32_points(1500, 2, seed=21)
    return pts, bulk_load(pts, 64, PageStore(64))


def _server(index, **kw):
    kw.setdefault("microbatch", 16)
    return DeviceQueryServer.from_index(index, device=CPU, **kw)


class _Oracle:
    def __init__(self, index):
        self.index = index

    def window(self, los, his):
        return window_query_batch(self.index, los, his)[0]

    def knn(self, qs, k):
        return knn_query_batch(self.index, qs, k)[0]


def _stream(n, d, seed):
    """The reference's deterministic mixed stream of (kind, *payload)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        c = rng.random(d) * 0.9
        if i % 3 == 2:
            out.append(("knn", np.clip(c, 0, 1)))
        else:
            out.append(("window", np.clip(c - 0.08, 0, 1), np.clip(c + 0.08, 0, 1)))
    return out


def _submit(fe, item):
    if item[0] == "window":
        return fe.submit_window(item[1], item[2])
    return fe.submit_knn(item[1], K)


def _check_served(oracle, reqs, stream):
    served = [(r, it) for r, it in zip(reqs, stream) if r.status == "ok"]
    w = [(r, it) for r, it in served if it[0] == "window"]
    if w:
        los = np.stack([it[1] for _, it in w])
        his = np.stack([it[2] for _, it in w])
        for (r, _), ref in zip(w, oracle.window(los, his)):
            assert np.array_equal(np.sort(r.ids), np.sort(ref))
    kq = [(r, it) for r, it in served if it[0] == "knn"]
    if kq:
        qs = np.stack([it[1] for _, it in kq])
        for (r, _), ref in zip(kq, oracle.knn(qs, K)):
            assert np.array_equal(r.ids, ref)
    return served


# --------------------------------------------------------------------------
# admission
# --------------------------------------------------------------------------
def test_queue_depth_never_exceeds_bound(setup):
    _, index = setup
    clock = VirtualClock()
    fe = Frontend(_server(index), clock=clock, queue_bound=8, batch_max=4,
                  batch_window_s=0.01)
    reqs = []
    for item in _stream(40, 2, seed=1):
        reqs.append(_submit(fe, item))
        assert fe.depth <= 8
        if len(reqs) % 13 == 0:
            clock.advance(0.02)
            fe.pump()
            assert fe.depth <= 8
    fe.drain()
    assert fe.stats.depth_peak <= 8 and fe.stats.rejected > 0
    for r in reqs:
        assert r.done
        if r.status == "rejected":
            assert "queue full" in r.reason
            assert r.cert is not None and not r.cert.complete and r.ids.size == 0


def test_rejected_after_stop(setup):
    _, index = setup
    fe = Frontend(_server(index), clock=VirtualClock(), queue_bound=8)
    fe.stop()
    r = fe.submit_window([0.1, 0.1], [0.2, 0.2])
    assert r.status == "rejected" and "stopped" in r.reason


# --------------------------------------------------------------------------
# saturation, batch forming, deadlines, brownout
# --------------------------------------------------------------------------
def test_burst_sheds_excess_with_certs_admitted_stay_exact(setup):
    pts, index = setup
    bound = 16
    fe = Frontend(_server(index), clock=VirtualClock(), queue_bound=bound, batch_max=8,
                  batch_window_s=0.001)
    stream = _stream(2 * bound, 2, seed=7)
    reqs = [_submit(fe, it) for it in stream]
    fe.drain()
    dropped = [r for r in reqs if r.status != "ok"]
    assert dropped
    for r in dropped:
        assert r.status == "rejected" and not r.cert.complete
    served = _check_served(_Oracle(index), reqs, stream)
    assert len(served) + len(dropped) == len(reqs)


def test_batch_closes_at_size_or_age(setup):
    _, index = setup
    clock = VirtualClock()
    fe = Frontend(_server(index), clock=clock, queue_bound=64, batch_max=4,
                  batch_window_s=0.01)
    reqs = [fe.submit_window([0.1, 0.1], [0.3, 0.3]) for _ in range(4)]
    assert fe.pump() == 1
    assert all(r.status == "ok" for r in reqs)
    r = fe.submit_window([0.1, 0.1], [0.3, 0.3])
    assert fe.pump() == 0 and not r.done
    clock.advance(0.009)
    assert fe.pump() == 0 and not r.done
    clock.advance(0.002)
    assert fe.pump() == 1 and r.status == "ok"
    a = fe.submit_knn([0.5, 0.5], 2)
    b = fe.submit_knn([0.5, 0.5], 3)
    clock.advance(0.02)
    assert fe.pump() == 2
    assert a.ids.size == 2 and b.ids.size == 3


def test_deadline_expired_in_queue_times_out_with_cert(setup):
    _, index = setup
    clock = VirtualClock()
    fe = Frontend(_server(index), clock=clock, queue_bound=16, batch_max=100,
                  batch_window_s=10.0, default_deadline_s=0.05)
    r1 = fe.submit_window([0.1, 0.1], [0.3, 0.3])
    r2 = fe.submit_window([0.1, 0.1], [0.3, 0.3], deadline_s=1.0)
    clock.advance(0.1)
    fe.pump()
    assert r1.status == "timeout" and not r1.cert.complete
    assert r2.status == "ok"
    assert fe.stats.timed_out == 1 and fe.stats.completed == 1


def test_brownout_hysteresis_does_not_flap(setup):
    _, index = setup
    clock = VirtualClock()
    fe = Frontend(_server(index), clock=clock, queue_bound=64, batch_max=999,
                  batch_window_s=0.005, brownout_high=16, brownout_low=4)
    for k in (1, 2, 3, 4):
        for _ in range(4):
            fe.submit_knn([0.5, 0.5], k)
        clock.advance(0.001)
    assert fe.brownout and fe.stats.brownout_enters == 1
    clock.advance(0.0015)
    assert fe.pump() == 1
    assert fe.depth == 12 and fe.brownout and fe.stats.brownout_exits == 0
    clock.advance(0.001)
    assert fe.pump() == 1
    assert fe.depth == 8 and fe.brownout and fe.stats.brownout_exits == 0
    clock.advance(0.001)
    assert fe.pump() == 1
    assert fe.depth == 4 and not fe.brownout and fe.stats.brownout_exits == 1
    for _ in range(11):
        fe.submit_knn([0.5, 0.5], 5)
    assert fe.depth == 15 and not fe.brownout and fe.stats.brownout_enters == 1
    fe.submit_knn([0.5, 0.5], 5)
    assert fe.brownout and fe.stats.brownout_enters == 2
    fe.drain()


def test_brownout_caps_knn_and_marks_requests(setup):
    _, index = setup
    fe = Frontend(_server(index), clock=VirtualClock(), queue_bound=32, batch_max=4,
                  batch_window_s=10.0, brownout_high=6, brownout_low=1,
                  brownout_knn_rounds=0)
    reqs = [fe.submit_knn(np.random.default_rng(i).random(2), K) for i in range(8)]
    assert fe.brownout
    fe.drain()
    assert all(r.status == "ok" and r.cert is not None for r in reqs)
    assert any(r.brownout for r in reqs) and fe.stats.brownout_batches > 0


# --------------------------------------------------------------------------
# determinism, and the same schedule through the reference's frontend
# --------------------------------------------------------------------------
def _run_schedule(fe_cls, clock, srv):
    fe = fe_cls(srv, clock=clock, queue_bound=12, batch_max=4, batch_window_s=0.01,
                default_deadline_s=0.5, brownout_high=8, brownout_low=2)
    reqs = []
    for i, item in enumerate(_stream(30, 2, seed=13)):
        reqs.append(_submit(fe, item))
        if i % 5 == 4:
            clock.advance(0.004)
            fe.pump()
    clock.advance(1.0)
    fe.drain()
    trace = [(r.status, r.reason,
              tuple(np.sort(r.ids).tolist()) if r.ids is not None else None,
              r.brownout, r.t_done) for r in reqs]
    return trace, fe.stats


def test_virtual_clock_replay_is_bit_identical_and_equals_the_reference(setup):
    pts, index = setup
    t1, s1 = _run_schedule(Frontend, VirtualClock(), _server(index))
    t2, s2 = _run_schedule(Frontend, VirtualClock(), _server(index))
    assert t1 == t2 and s1 == s2
    ref_srv = RefServer.from_index(ref_bulk_load(pts, 64, RefPageStore(64)), microbatch=16)
    tr, sr = _run_schedule(RefFrontend, RefClock(), ref_srv)
    assert t1 == tr
    assert {k: v for k, v in vars(s1).items() if k != "errors"} == vars(sr)
    assert s1.errors == 0


# --------------------------------------------------------------------------
# fault points: admission, batch_close; errors that are not faults
# --------------------------------------------------------------------------
def test_admission_fault_point_rejects(setup):
    _, index = setup
    plan = FaultPlan([FaultRule("admission", rate=1.0, max_fires=2)], seed=5)
    fe = Frontend(_server(index), clock=VirtualClock(), queue_bound=16, fault_plan=plan)
    r1 = fe.submit_window([0.1, 0.1], [0.2, 0.2])
    r2 = fe.submit_knn([0.5, 0.5], K)
    r3 = fe.submit_window([0.1, 0.1], [0.2, 0.2])
    assert r1.status == "rejected" and "fault" in r1.reason
    assert r2.status == "rejected" and r2.cert is not None
    assert r3.status == "queued"
    fe.drain()
    assert r3.status == "ok"


def test_batch_close_fault_retries_then_serves(setup):
    _, index = setup
    plan = FaultPlan([FaultRule("batch_close", at_calls={1})], seed=5)
    srv = _server(index, retry=RetryPolicy(max_attempts=2, sleep=lambda s: None))
    fe = Frontend(srv, clock=VirtualClock(), queue_bound=16, batch_max=2,
                  batch_window_s=0.001, fault_plan=plan)
    r1 = fe.submit_window([0.1, 0.1], [0.4, 0.4])
    r2 = fe.submit_window([0.2, 0.2], [0.5, 0.5])
    fe.drain()
    assert r1.status == "ok" and r2.status == "ok"


def test_batch_close_fault_exhausting_retries_sheds_with_certs(setup):
    _, index = setup
    plan = FaultPlan([FaultRule("batch_close", rate=1.0)], seed=5)
    srv = _server(index, retry=RetryPolicy(max_attempts=2, sleep=lambda s: None))
    fe = Frontend(srv, clock=VirtualClock(), queue_bound=16, batch_max=2,
                  batch_window_s=0.001, fault_plan=plan)
    reqs = [fe.submit_window([0.1, 0.1], [0.4, 0.4]) for _ in range(4)]
    fe.drain()
    for r in reqs:
        assert r.status == "shed" and not r.cert.complete
        assert "dispatch failed" in r.reason
    assert fe.stats.shed == 4 and fe.stats.errors == 0


@pytest.mark.parametrize("where", ["dispatch", "refinement", "realtime"])
def test_device_errors_are_neither_retried_nor_shed(setup, monkeypatch, where):
    """A kernel or CUDA error in a dispatch or a refinement reaches the
    caller on its first attempt: its requests end in ``error`` with the
    exception kept, none is shed, and ``pump()`` (virtual mode) or
    ``drain()``/``stop()`` (real time) raises it."""
    import repro_torch.serve.engine as E

    pts, index = setup
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        raise RuntimeError("kernel launch failed")

    if where == "refinement":
        srv = DeviceQueryServer.from_ambi(AMBI(pts, 64), microbatch=16, device=CPU)
        monkeypatch.setattr(srv.ambi, "window", broken)
    else:
        srv = _server(index)
        monkeypatch.setattr(E, "window_query_batch_torch", broken)
    if where == "realtime":
        fe = Frontend(srv, queue_bound=16, batch_max=4, batch_window_s=0.001).start()
        reqs = [fe.submit_window([0.1, 0.1], [0.5, 0.5]) for _ in range(4)]
        for r in reqs:
            assert r.wait(30.0)
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            fe.stop()
    else:
        fe = Frontend(srv, clock=VirtualClock(), queue_bound=16, batch_max=4,
                      batch_window_s=0.001)
        reqs = [fe.submit_window([0.1, 0.1], [0.5, 0.5]) for _ in range(4)]
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            fe.pump()
        fe.drain()   # the error was raised once
    for r in reqs:
        assert r.status == "error" and isinstance(r.error, RuntimeError)
        assert r.ids.size == 0 and not r.cert.complete
    st = fe.stats
    assert (st.shed, st.completed, st.errors) == (0, 0, 4)
    assert srv.stats.retries == 0 and len(calls) == 1


# --------------------------------------------------------------------------
# real time
# --------------------------------------------------------------------------
def test_realtime_dispatcher_serves_and_drains(setup):
    _, index = setup
    fe = Frontend(_server(index), queue_bound=256, batch_max=8, batch_window_s=0.001).start()
    stream = _stream(40, 2, seed=3)
    reqs = [_submit(fe, it) for it in stream]
    for r in reqs:
        assert r.wait(30.0)
    fe.stop()
    assert _check_served(_Oracle(index), reqs, stream)


def test_virtual_mode_rejects_start(setup):
    _, index = setup
    fe = Frontend(_server(index), clock=VirtualClock())
    with pytest.raises(RuntimeError, match="VirtualClock"):
        fe.start()


# --------------------------------------------------------------------------
# adaptive serving through the frontend
# --------------------------------------------------------------------------
def _adaptive_server(pts, M=64, **kw):
    kw.setdefault("microbatch", 16)
    return DeviceQueryServer.from_ambi(AMBI(pts, M), device=CPU, **kw)


def _brute_window(pts, lo, hi):
    return np.sort(np.flatnonzero((pts >= lo).all(axis=1) & (pts <= hi).all(axis=1)))


def test_adaptive_overlap_refines_on_second_lane_and_stays_exact(setup):
    pts, _ = setup
    srv = _adaptive_server(pts)
    clock = VirtualClock()
    fe = Frontend(srv, clock=clock, queue_bound=64, batch_max=8, batch_window_s=0.001)
    rng = np.random.default_rng(11)
    reqs = []
    for _ in range(16):
        c = rng.random(2) * 0.9
        reqs.append(fe.submit_window(np.clip(c - 0.06, 0, 1), np.clip(c + 0.06, 0, 1)))
    clock.advance(0.01)
    fe.pump()
    fe.drain()
    assert fe.stats.refine_batches > 0
    for r in reqs:
        assert r.status == "ok"
        assert np.array_equal(np.sort(r.ids), _brute_window(pts, *r.payload))


def test_adaptive_brownout_serves_device_only_with_certs(setup):
    pts, _ = setup
    srv = _adaptive_server(pts)
    fe = Frontend(srv, clock=VirtualClock(), queue_bound=64, batch_max=4,
                  batch_window_s=10.0, brownout_high=6, brownout_low=1)
    rng = np.random.default_rng(12)
    reqs = []
    for _ in range(12):
        c = rng.random(2) * 0.9
        reqs.append(fe.submit_window(np.clip(c - 0.06, 0, 1), np.clip(c + 0.06, 0, 1)))
    assert fe.brownout
    grafts_before = srv.stats.grafts
    fe.drain()
    brown = [r for r in reqs if r.brownout]
    assert brown and srv.stats.grafts == grafts_before
    degraded = [r for r in brown if not r.cert.complete]
    assert degraded
    for r in degraded:
        assert r.cert.missing_lo is not None and len(r.cert.missing_lo) > 0
        lo, hi = r.payload
        if r.ids.size:
            assert ((pts[r.ids] >= lo) & (pts[r.ids] <= hi)).all()


def test_table_lock_queries_racing_refinement_stay_exact():
    pts = f32_points(4000, 2, seed=33)
    srv = _adaptive_server(pts, M=64)
    errors = []

    def worker(rng):
        try:
            for _ in range(12):
                c = rng.random((8, 2)) * 0.9
                los, his = np.clip(c - 0.05, 0, 1), np.clip(c + 0.05, 0, 1)
                for lo, hi, ids in zip(los, his, srv.window(los, his)):
                    if not np.array_equal(np.sort(ids), _brute_window(pts, lo, hi)):
                        errors.append((lo, hi))
                        return
        except Exception as e:  # pragma: no cover - the regression itself
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(np.random.default_rng(s),))
               for s in (1, 2, 3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert not errors, errors[:2]
    assert srv.ambi.is_fully_refined() or srv.stats.grafts > 0


# --------------------------------------------------------------------------
# a streaming server behind the frontend
# --------------------------------------------------------------------------
def test_streaming_server_behind_the_frontend(setup):
    """A burst of mixed requests over a streaming server mid-ingest, with
    tombstones: admitted answers equal the server's direct answers,
    rejected ones carry certificates."""
    pts, _ = setup
    srv = DeviceQueryServer.from_streaming(StreamingIndex(pts, **STREAM_KW),
                                           microbatch=16, device=CPU)
    rng = np.random.default_rng(4)
    for _ in range(4):
        srv.insert(f32_points(200, 2, seed=int(rng.integers(1 << 30))))
        srv.delete(rng.integers(0, srv.stream.n_ids, size=30))
    assert srv.stream.tiers and srv.stream.shadow
    fe = Frontend(srv, clock=VirtualClock(), queue_bound=16, batch_max=8,
                  batch_window_s=0.001)
    stream = _stream(48, 2, seed=9)
    reqs = [_submit(fe, it) for it in stream]
    fe.drain()
    assert fe.stats.rejected > 0
    ok = [(r, it) for r, it in zip(reqs, stream) if r.status == "ok"]
    for r, it in zip(reqs, stream):
        assert r.status in ("ok", "rejected")
        if r.status == "rejected":
            assert not r.cert.complete
    for r, it in ok:
        if it[0] == "window":
            want = srv.window(it[1][None], it[2][None])[0]
            assert np.array_equal(np.sort(r.ids), want)
        else:
            assert np.array_equal(r.ids, srv.knn(it[1][None], K)[0])
        assert not np.isin(r.ids, np.flatnonzero(~srv.stream.live_mask())).any()


# --------------------------------------------------------------------------
# the two single-device chaos scenarios of the reference
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def chaos():
    pts = f32_points(900, 2, seed=21)
    rng = np.random.default_rng(4)
    c = rng.random((16, 2))
    return (pts, bulk_load(pts, 64, PageStore(64)), np.clip(c - 0.15, 0, 1),
            np.clip(c + 0.15, 0, 1), rng.random((16, 2)))


def _chaos_server(pts, plan, attempts):
    srv = DeviceQueryServer.from_ambi(AMBI(pts, 250), microbatch=32, device=CPU)
    srv.fault_plan = plan
    srv.retry = RetryPolicy(max_attempts=attempts, sleep=lambda s: None)
    return srv


def _parity(oracle, srv, los, his, qs):
    for a, b in zip(srv.window(los, his), oracle.window(los, his)):
        assert np.array_equal(np.sort(a), np.sort(b))
    for a, b in zip(srv.knn(qs, 5), oracle.knn(qs, 5)):
        assert np.array_equal(a, b)


def test_chaos_parity_adaptive_under_storm(chaos):
    pts, index, los, his, qs = chaos
    plan = FaultPlan.storm(
        ("shard_dispatch", "host_refine", "pagestore_read", "apply_delta"),
        0.3, seed=1337, max_fires_per_point=2,
    )
    srv = _chaos_server(pts, plan, 6)
    srv.ambi.store.fault_hook = plan.pagestore_hook()
    _parity(_Oracle(index), srv, los, his, qs)
    assert plan.total_fires > 0 and srv.stats.retries > 0


def test_chaos_adaptive_serves_through_device_outage(chaos):
    pts, index, los, his, qs = chaos
    srv = _chaos_server(pts, FaultPlan([FaultRule("shard_dispatch", rate=1.0)], seed=1337), 2)
    srv.breaker_threshold = 1
    _parity(_Oracle(index), srv, los, his, qs)
    assert srv.stats.host_fallbacks > 0 and srv.stats.degraded_queries == 0
    _res, certs = srv.window(los, his, return_certs=True)
    assert all(c.complete for c in certs)
