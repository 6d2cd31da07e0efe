"""The port's tracer (``repro_torch.tracing``): spans off and on, the
engine's counters against what the engine did, and the launch counts in
the tracer's registry.

Everything runs on the CPU (``device="cpu"``): the kernels' plain
versions, the same engine code around them.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import DeviceTable, PageStore, bulk_load, knn_query_batch_torch
from repro_torch.core import queries_torch as QT
from repro_torch.kernels import launches
from repro_torch.serve import DeviceQueryServer

M = 24          # buffer pages


@pytest.fixture(autouse=True)
def clean_tracer():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def served():
    rng = np.random.default_rng(7)
    centres = rng.random((6, 5))
    pts = (centres[rng.integers(0, 6, 20_000)]
           + 0.05 * rng.standard_normal((20_000, 5)))
    pts = pts.astype(np.float32).astype(np.float64)
    idx = bulk_load(pts, M, PageStore(M))
    srv = DeviceQueryServer.from_index(idx, microbatch=256, device="cpu")
    rows = pts[rng.integers(0, len(pts), 64)].astype(np.float32)
    return pts, idx, srv, rows


def _windows(rows, half=0.02):
    return rows - np.float32(half), rows + np.float32(half)


class _CountingRecordFunction:
    """Stands in for ``torch.profiler.record_function``: counts entries."""
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


def test_off_records_no_span_and_enters_no_record_function(served, monkeypatch):
    _, _, srv, rows = served
    _CountingRecordFunction.entered = 0
    monkeypatch.setattr(torch.profiler, "record_function", _CountingRecordFunction)
    srv.window(*_windows(rows))
    srv.knn(rows, 16)
    assert _CountingRecordFunction.entered == 0
    assert tracing.totals() == {} and tracing.requests() == []
    c = tracing.counters()
    assert c["engine.window_batches"] == 1 and c["engine.knn_batches"] == 1
    assert c["engine.pairs"] > 0 and c["engine.ids"] > 0 and c["engine.knn_rounds"] >= 1
    # on, the same calls enter it once per span
    tracing.enable()
    srv.knn(rows, 16)
    assert _CountingRecordFunction.entered == sum(t["calls"] for t in tracing.totals().values())
    assert _CountingRecordFunction.entered >= 4   # serve, engine, a wait, answers


def test_on_spans_nest_share_a_request_and_split_self_time(served):
    _, _, srv, rows = served
    tracing.enable()
    srv.window(*_windows(rows))
    srv.knn(rows, 16)
    reqs = tracing.requests()
    assert [r[0].name for r in reqs] == ["serve.window", "serve.knn"]
    assert reqs[0][0].request != reqs[1][0].request
    for req, engine in zip(reqs, ("engine.window", "engine.knn")):
        root = req[0]
        assert root.parent is None
        assert len({s.request for s in req}) == 1
        names = [s.name for s in req]
        assert names[1] == engine and req[1].parent == 0
        for i, s in enumerate(req[2:], start=2):
            assert s.name in ("engine.wait", "engine.answers")
            assert s.parent == 1
            assert req[s.parent].start_ns <= s.start_ns <= s.end_ns <= req[s.parent].end_ns
        assert names.count("engine.answers") == 1
        for i, s in enumerate(req):
            children = [c for c in req if c.parent == i]
            assert s.child_ns == sum(c.end_ns - c.start_ns for c in children)
            assert s.self_seconds == pytest.approx(
                s.seconds - sum(c.seconds for c in children), abs=1e-12)
    tot = tracing.totals()
    for name in ("serve.window", "engine.window", "engine.wait", "engine.answers"):
        assert tot[name]["calls"] >= 1
    spans = [s for r in reqs for s in r]
    for name, t in tot.items():
        mine = [s for s in spans if s.name == name]
        assert t["calls"] == len(mine)
        assert t["seconds"] == pytest.approx(sum(s.seconds for s in mine), rel=1e-9)
        assert t["self_seconds"] == pytest.approx(sum(s.self_seconds for s in mine), rel=1e-9)


def test_pair_chunks_and_pairs_come_from_the_engine(served, monkeypatch):
    _, idx, _, rows = served
    dev = DeviceTable.from_index(idx, device="cpu")
    los, his = _windows(rows, 0.08)
    hits, _ = QT._frontier_count(dev, torch.from_numpy(los), torch.from_numpy(his))
    pairs = int(hits[:, : dev.n_leaves].sum())
    monkeypatch.setattr(QT, "PAIR_CHUNK", 64)
    assert pairs > 4 * 64
    tracing.enable()
    res = QT.window_query_batch_torch(dev, los, his)
    c = tracing.counters()
    assert c["engine.pairs"] == pairs
    assert c["engine.pair_chunks"] == -(-pairs // 64)
    assert c["engine.ids"] == sum(len(r) for r in res)
    (req,) = tracing.requests()
    # one wait for the pair count, one per chunk
    assert [s.name for s in req].count("engine.wait") == 1 + c["engine.pair_chunks"]


@pytest.mark.parametrize("max_rounds", [None, 1])
def test_knn_rounds_and_requeued_queries(served, monkeypatch, max_rounds):
    _, idx, _, rows = served
    dev = DeviceTable.from_index(idx, device="cpu")
    cores, failed = [], []
    core, pending = QT._knn_core_fused, QT._knn_pending

    def counting_core(*a, **kw):
        cores.append(1)
        return core(*a, **kw)

    def counting_pending(qs, exact, p):
        failed.append(int((~exact).sum()))
        return pending(qs, exact, p)

    monkeypatch.setattr(QT, "_knn_core_fused", counting_core)
    monkeypatch.setattr(QT, "_knn_pending", counting_pending)
    knn_query_batch_torch(dev, rows, 64, n_candidate_leaves=1, max_rounds=max_rounds)
    c = tracing.counters()
    assert len(cores) > 1                                # later rounds ran
    assert c["engine.knn_rounds"] == len(cores)          # the first and each later one
    assert c["engine.knn_requeued"] == sum(failed) > 0
    assert c["engine.knn_batches"] == 1


def test_answers_hand_off_counters(served):
    _, _, srv, rows = served
    srv.window(*_windows(rows))
    c = tracing.counters()
    # on a CPU export no hand-off lands in page-locked memory
    assert c["engine.answers_pinned"] == 0 and c["engine.answers_fresh_blocks"] == 0
    tracing.count("engine.answers_pinned", 3)
    tracing.count("engine.answers_fresh_blocks", 1)
    tracing.zero_counters("engine.")
    c = tracing.counters()
    assert c["engine.answers_pinned"] == 0 and c["engine.answers_fresh_blocks"] == 0


def test_answers_are_the_same_with_tracing_on(served):
    _, _, srv, rows = served
    los, his = _windows(rows)
    off_w, off_k = srv.window(los, his), srv.knn(rows, 16)
    tracing.enable()
    on_w, on_k = srv.window(los, his), srv.knn(rows, 16)
    for a, b in zip(off_w + off_k, on_w + on_k):
        np.testing.assert_array_equal(a, b)


def test_bulk_load_and_export_spans():
    # at d = 20 a branch holds 24 entries and a leaf 48 points: with a
    # buffer of 25 pages every subspace of 40k points is dense, so the
    # bulk load recurses
    pts = np.random.default_rng(3).random((40_000, 20)).astype(np.float32).astype(np.float64)
    idx = bulk_load(pts, 25, PageStore(25))
    tracing.enable()
    again = bulk_load(pts, 25, PageStore(25))
    DeviceTable.from_index(again, device="cpu")
    for col in QT.NodeTable.COLUMNS:   # tracing leaves the index as it was
        np.testing.assert_array_equal(getattr(again.table, col), getattr(idx.table, col))
    load, export = tracing.requests()
    assert load[0].name == "bulk_load" and load[0].parent is None
    names = {s.name for s in load}
    assert names == {"bulk_load", "bulk_load.route", "bulk_load.refine"}
    # the recursion: a route at more than one depth
    assert sum(s.name == "bulk_load.route" for s in load) > 1
    own = sum(s.self_seconds for s in load if s.name != "bulk_load")
    assert own <= load[0].seconds
    assert [s.name for s in export] == ["export", "export.layout"]
    assert export[1].parent == 0


def test_launch_counts_live_in_the_registry():
    launches.reset()
    assert launches.counts() == dict.fromkeys(launches.KERNELS, 0)
    tracing.count("engine.pairs", 5)
    launches.bump("box_hits")
    launches.bump("box_hits")
    launches.bump("pair_dist2")
    assert launches.counts() == {**dict.fromkeys(launches.KERNELS, 0),
                                 "box_hits": 2, "pair_dist2": 1}
    assert tracing.counters()["launch.box_hits"] == 2
    launches.reset()   # the launch counts only
    assert launches.counts() == dict.fromkeys(launches.KERNELS, 0)
    assert tracing.counters()["engine.pairs"] == 5
    with pytest.raises(KeyError):
        launches.bump("no_such_kernel")
    tracing.reset()
    assert tracing.counters() == {}
    assert launches.counts() == dict.fromkeys(launches.KERNELS, 0)


def test_kept_requests_are_bounded_and_totals_are_not():
    tracing.enable()
    n = tracing.KEEP_REQUESTS + 10
    for _ in range(n):
        with tracing.span("root"):
            with tracing.span("child"):
                pass
    reqs = tracing.requests()
    assert len(reqs) == tracing.KEEP_REQUESTS
    assert reqs[-1][0].request - reqs[0][0].request == tracing.KEEP_REQUESTS - 1
    assert tracing.totals()["root"]["calls"] == n
    assert tracing.totals()["child"]["calls"] == n


def test_threads_keep_their_own_stacks_and_lose_no_count():
    """More threads than cores, a short switch interval: no counter update
    is lost, and each thread's spans nest in requests of their own."""
    threads, rounds = 16, 200
    tracing.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(rounds):
                tracing.count("stress")
                with tracing.span("outer"):
                    tracing.count("stress", 2)
                    with tracing.span("inner"):
                        pass

        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert tracing.counters()["stress"] == 3 * threads * rounds
    reqs = tracing.requests()
    assert len(reqs) == threads * rounds
    assert len({r[0].request for r in reqs}) == threads * rounds
    for r in reqs:
        assert [(s.name, s.parent) for s in r] == [("outer", None), ("inner", 0)]
        assert r[1].request == r[0].request
