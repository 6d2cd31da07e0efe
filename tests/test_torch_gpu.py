"""The port's CUDA kernels and engine on the card (``gpu`` marker).

Imports only torch, numpy and the port, so it collects on a machine with
a card and no JAX:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card every test skips (the decision is taken inside the fixture,
not at import).  Each kernel is held bit for bit against its plain version
on the same CUDA tensors, the engine's answers on a ``cuda`` export against
the same export on the CPU (where every kernel runs as its plain version),
a ``RetrievalServer`` on the card against the same server on the CPU,
a streaming ``DeviceQueryServer`` (with recovery and the frontend) and
sharded servers (static, a dead shard and its repair, streaming) on the
card against the same server on the CPU and a brute force, and the
collective build and rounds on ranks on the card against the same ranks
on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (
    AMBI,
    DeviceTable,
    PageStore,
    ShardedDeviceTable,
    StreamingIndex,
    bulk_load,
    compress_boxes_bf16,
    knn_query_batch_torch,
    window_query_batch_torch,
)
from repro_torch.core.datasets import osm_like
from repro_torch.kernels import knn_topk, launches, ops, partition_assign, ref, window_filter
from repro_torch.serve import DeviceQueryServer, RetrievalServer

F32_MAX = np.finfo(np.float32).max


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(rng, d, bf16, nq=300, n_l=500, s=64, p=2000):
    qlo = rng.random((nq, d)).astype(np.float32)
    qhi = (qlo + rng.random((nq, d)).astype(np.float32) * np.float32(0.3))
    lo = rng.random((n_l, d)).astype(np.float32)
    hi = (lo + rng.random((n_l, d)).astype(np.float32) * np.float32(0.25))
    if bf16:
        blo, bhi = (torch.from_numpy(u.view(np.int16)).view(torch.bfloat16)
                    for u in compress_boxes_bf16(lo, hi))
    else:
        blo, bhi = torch.from_numpy(lo), torch.from_numpy(hi)
    counts = rng.integers(0, s + 1, n_l).astype(np.int32)
    counts[: n_l // 4] = 0
    pts = rng.random((n_l, s, d)).astype(np.float32)
    ids = rng.permutation(n_l * s).reshape(n_l, s).astype(np.int32)
    pad = np.arange(s)[None, :] >= counts[:, None]
    pts[pad], ids[pad] = F32_MAX, -1
    q_idx = rng.integers(0, nq, p).astype(np.int32)
    leaf_idx = rng.integers(0, n_l, p).astype(np.int32)
    pv = (rng.random(p) < 0.8).astype(np.int32)
    return qlo, qhi, lo, hi, blo, bhi, pts, ids, counts, q_idx, leaf_idx, pv


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2, 3, 5])
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_kernels_match_plain(cuda, d, bf16):
    qlo, qhi, lo, hi, blo, bhi, pts, ids, counts, q_idx, leaf_idx, pv = _inputs(
        np.random.default_rng(d + 10 * bf16), d, bf16)
    cases = [
        (window_filter.box_hits, ref.box_hits_tiled_ref, (blo, bhi, qlo, qhi)),
        (knn_topk.leaf_mindist, ref.leaf_mindist_ref, (qlo, blo, bhi)),
        (window_filter.pair_window_ids, ref.pair_window_ids_ref,
         (qlo, qhi, lo, hi, pts, ids, counts, q_idx, leaf_idx, pv)),
        (knn_topk.pair_dist2, ref.pair_dist2_ref, (qlo, pts, counts, q_idx, leaf_idx)),
    ]
    for kernel, plain, args in cases:
        args = tuple((torch.from_numpy(a) if isinstance(a, np.ndarray) else a).to(cuda)
                     for a in args)
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), kernel.__name__


@pytest.mark.gpu
def test_cuda_launchers_reject_bad_arguments(cuda):
    f = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=cuda)
    with pytest.raises(TypeError):
        window_filter.box_hits(f(4, 2, dtype=torch.float64), f(4, 2), f(3, 2), f(3, 2))
    with pytest.raises(ValueError, match="contiguous"):
        knn_topk.leaf_mindist(f(2, 3).t(), f(4, 2), f(4, 2))
    with pytest.raises(ValueError, match="shape"):
        knn_topk.pair_dist2(f(3, 2), f(4, 5, 2), f(5, dtype=torch.int32),
                            f(6, dtype=torch.int32), f(6, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        knn_topk.leaf_mindist(f(3, 2), f(4, 2), f(4, 2).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("compressed", [False, True])
def test_engine_on_the_card_matches_the_plain_engine(cuda, compressed):
    rng = np.random.default_rng(0)
    # 294 data pages over a 60-page buffer: Step 1 samples 204 of them
    pts = (rng.random((100_000, 2)) ** 2).astype(np.float32).astype(np.float64)
    idx = bulk_load(pts, 60, PageStore(60))
    on_card = DeviceTable.from_index(idx, compressed=compressed)
    on_cpu = DeviceTable.from_index(idx, compressed=compressed, device="cpu")
    assert on_card.device.type == "cuda"
    c = rng.random((200, 2)).astype(np.float32)
    los, his = c - np.float32(0.03), c + np.float32(0.03)
    launches.reset()
    got = window_query_batch_torch(on_card, los, his)
    want = window_query_batch_torch(on_cpu, los, his)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    qs = rng.random((200, 2)).astype(np.float32)
    gi, gd, ge = knn_query_batch_torch(on_card, qs, 10, return_dists=True,
                                       return_exact=True)
    wi, wd, we = knn_query_batch_torch(on_cpu, qs, 10, return_dists=True,
                                       return_exact=True)
    np.testing.assert_array_equal(ge, we)
    for a, b in zip(gd, wd):
        np.testing.assert_array_equal(a, b)
    counts = launches.counts()
    engine = ("box_hits", "pair_window_ids", "leaf_mindist", "pair_dist2")
    assert all(counts[k] > 0 for k in engine), counts



def _hotspots(rng, steps, per_step):
    centres = (np.full(2, 0.3), np.full(2, 0.7))
    return [(centres[s % 2] + rng.random((per_step, 2)) * 0.08)
            .astype(np.float32).astype(np.float64) for s in range(steps)]


@pytest.mark.gpu
@pytest.mark.parametrize("compressed", [False, True])
def test_adaptive_server_on_the_card_matches_the_cpu_server(cuda, compressed):
    """The adaptive ``DeviceQueryServer`` on the card against the same
    server on the CPU over a hotspot stream: equal answers, serving and
    upload counters and AMBI tables; the four main-path kernels launched,
    and no retry, host fallback or degraded answer hid a device fault."""
    pts = np.random.default_rng(1).random((60_000, 2)).astype(np.float32).astype(np.float64)
    servers = [DeviceQueryServer.from_ambi(AMBI(pts, 80), microbatch=16,
                                           compressed=compressed, device=dev)
               for dev in (None, "cpu")]
    assert servers[0].dev.device.type == "cuda"
    launches.reset()
    for batch in _hotspots(np.random.default_rng(2), 8, 16):
        los, his = batch - 0.01, batch + 0.01
        got, want = (srv.window(los, his) for srv in servers)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.sort(a), np.sort(b))
        got, want = (srv.knn(batch, 16) for srv in servers)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    counts = launches.counts()
    engine = ("box_hits", "pair_window_ids", "leaf_mindist", "pair_dist2")
    assert all(counts[k] > 0 for k in engine), counts
    card, cpu = servers
    assert card.stats == cpu.stats
    assert card.upload_stats == cpu.upload_stats
    assert card.stats.delta_refreshes > 0 and card.stats.hot_queries > 0
    assert card.stats.retries == card.stats.host_fallbacks == 0
    assert card.stats.degraded_queries == 0
    for c in ("mbb_lo", "mbb_hi", "perm", "unrefined", "leaf_count"):
        np.testing.assert_array_equal(getattr(card.ambi.table, c),
                                      getattr(cpu.ambi.table, c))
    np.testing.assert_array_equal(card.dev.leaf_ids.cpu().numpy(), card.dev.host_ids)


def _live_brute(stream, lo, hi):
    live = stream.live_ids()
    p = stream.points[live]
    return live[((p >= lo) & (p <= hi)).all(axis=1)]


def _live_knn(stream, q, k):
    live = stream.live_ids()
    d2 = np.sum((stream.points[live] - q) ** 2, axis=1)
    return live[np.lexsort((live, d2))[:k]]


@pytest.mark.gpu
@pytest.mark.parametrize("compressed", [False, True])
def test_streaming_server_on_the_card_matches_the_cpu_server(cuda, compressed):
    """A streaming ``DeviceQueryServer`` on the card against the same
    server on the CPU and a brute force over the live rows, through
    flushes, fusions and rebuild-merges, with 300 tombstones in the base
    tier (k-NN over-fetches k_eff = 512 > S = 341): equal answers,
    counters and mirror tables; one full export, one delta per sync; the
    four main-path kernels launched; no retry or host fallback."""
    rng = np.random.default_rng(5)
    pts = rng.random((20_000, 2)).astype(np.float32).astype(np.float64)
    # the base tier (level 2) never merges with the inserted ones (level
    # <= 1), so its 300 tombstones stay in the shadow
    kw = dict(delta_threshold=1024, delta_index_every=256, size_ratio=4)
    servers = [DeviceQueryServer.from_streaming(StreamingIndex(pts, **kw), microbatch=64,
                                                compressed=compressed, device=dev)
               for dev in (None, "cpu")]
    card, cpu = servers
    assert card.dev.device.type == "cuda"
    launches.reset()
    base_dels = rng.choice(20_000, size=300, replace=False)
    for step in range(12):
        ins = rng.random((1024, 2)).astype(np.float32).astype(np.float64)
        ids = [srv.insert(ins) for srv in servers]
        np.testing.assert_array_equal(ids[0], ids[1])
        if step % 4 == 3:
            dels = np.concatenate([base_dels[step // 4 * 100:(step // 4 + 1) * 100],
                                   rng.choice(ids[0], 16, replace=False)])
            assert card.delete(dels) == cpu.delete(dels)
        assert not card._stream_is_stale()
        c = rng.random((64, 2)).astype(np.float32).astype(np.float64)
        los, his = c - 0.01, c + 0.01
        got, want = (srv.window(los, his) for srv in servers)
        for i, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, _live_brute(card.stream, los[i], his[i]))
        got, want = (srv.knn(c, 16) for srv in servers)
        for i, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, _live_knn(card.stream, c[i], 16))
    assert card._k_eff(16) == 512 > card.dev.leaf_size
    s = card.stream
    assert s.flushes >= 4 and s.fusions >= 1 and s.merges >= 1
    counts = launches.counts()
    engine = ("box_hits", "pair_window_ids", "leaf_mindist", "pair_dist2")
    assert all(counts[k] > 0 for k in engine), counts
    assert card.stats == cpu.stats
    assert card.upload_stats == cpu.upload_stats
    assert card.upload_stats["full_exports"] == 1
    assert card.stats.delta_refreshes == card.stats.stream_syncs > 0
    assert (card.stats.retries, card.stats.host_fallbacks, card.stats.degraded_queries) == (0, 0, 0)
    for c in ("mbb_lo", "mbb_hi", "perm", "leaf_count", "first_child", "child_count"):
        np.testing.assert_array_equal(getattr(card.mirror.table, c),
                                      getattr(cpu.mirror.table, c))
    np.testing.assert_array_equal(card.dev.leaf_ids.cpu().numpy(), card.dev.host_ids)


@pytest.mark.gpu
def test_streaming_recovery_and_frontend_on_the_card(cuda, tmp_path):
    """A journaled streaming server on the card, killed after a barrier
    and more ingest, recovers on the card with the same answers; a
    ``Frontend`` over it serves a burst as the server does directly."""
    from repro_torch.serve import Frontend, VirtualClock

    rng = np.random.default_rng(6)
    pts = rng.random((10_000, 2)).astype(np.float32).astype(np.float64)
    kw = dict(delta_threshold=1024, delta_index_every=256, size_ratio=4)
    live = DeviceQueryServer.from_streaming(
        StreamingIndex(pts, **kw), microbatch=64, journal_path=tmp_path / "ops.journal",
        snapshot_path=tmp_path / "snap.npz")
    for step in range(6):
        live.insert(rng.random((700, 2)).astype(np.float32).astype(np.float64))
        live.delete(rng.integers(0, live.stream.n_ids, 40))
        if step == 2:
            live.checkpoint()
    rec = DeviceQueryServer.recover(tmp_path / "snap.npz", tmp_path / "ops.journal",
                                    microbatch=64)
    assert rec.dev.device.type == "cuda" and rec.stats.replayed_records == 6
    c = rng.random((64, 2)).astype(np.float32).astype(np.float64)
    for a, b in zip(rec.window(c - 0.02, c + 0.02), live.window(c - 0.02, c + 0.02)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(rec.knn(c, 16), live.knn(c, 16)):
        np.testing.assert_array_equal(a, b)
    fe = Frontend(rec, clock=VirtualClock(), queue_bound=64, batch_max=32,
                  batch_window_s=0.001)
    reqs = [fe.submit_window(lo, lo + 0.04) for lo in c[:48]] + [
        fe.submit_knn(q, 16) for q in c[:48]]
    fe.drain()
    assert fe.stats.rejected == 32 and fe.stats.errors == 0
    for r in reqs:
        if r.status != "ok":
            assert r.status == "rejected" and not r.cert.complete
        elif r.kind == "window":
            lo, hi = r.payload
            np.testing.assert_array_equal(r.ids, live.window(lo[None], hi[None])[0])
        else:
            np.testing.assert_array_equal(r.ids, live.knn(r.payload[0][None], 16)[0])
    assert (rec.stats.retries, rec.stats.host_fallbacks) == (0, 0)


def _sharded_pair(m, kw=lambda dev: {}):
    """A sharded server over one FMBI index on the card and on the CPU."""
    pts = np.random.default_rng(7).random((40_000, 2)).astype(np.float32).astype(np.float64)
    idx = bulk_load(pts, 250, PageStore(250))
    servers = [DeviceQueryServer.from_index(idx, shards=m, microbatch=64, device=dev,
                                            **kw(dev))
               for dev in (None, "cpu")]
    assert servers[0].sdev.device.type == "cuda" and servers[0].stats.shards == m
    return pts, servers


MAIN_PATH = ("box_hits", "pair_window_ids", "leaf_mindist", "pair_dist2")


def _brute_f32(pts, lo, hi):
    """Window ids over the points as the card holds them (f32 compares)."""
    p, lo, hi = (np.asarray(x, dtype=np.float32) for x in (pts, lo, hi))
    return np.flatnonzero(((p >= lo) & (p <= hi)).all(axis=1))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [2, 4])
def test_sharded_server_on_the_card_matches_the_cpu_server(cuda, m):
    """``DeviceQueryServer(shards=m)`` on the card against the same server
    on the CPU: equal answers (windows fanned out to the qualified shards,
    the two-round k-NN), equal counters, the brute force on a sample; the
    four main-path kernels launched and no retry or host fallback."""
    pts, (card, cpu) = _sharded_pair(m)
    rng = np.random.default_rng(8)
    c = rng.random((200, 2)).astype(np.float32).astype(np.float64)
    los, his = c - 0.02, c + 0.02
    launches.reset()
    got, want = (srv.window(los, his) for srv in (card, cpu))
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))
        if i < 16:
            np.testing.assert_array_equal(np.sort(a), _brute_f32(pts, los[i], his[i]))
    got, want = (srv.knn(c, 16) for srv in (card, cpu))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    counts = launches.counts()
    assert all(counts[k] > 0 for k in MAIN_PATH), counts
    assert card.stats == cpu.stats and card.upload_stats == cpu.upload_stats
    assert (card.stats.retries, card.stats.host_fallbacks) == (0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [2, 4])
def test_sharded_outage_and_repair_on_the_card(cuda, m):
    """Shard 1 dead (an injected fault on every dispatch): the degraded
    answers and certificates on the card equal the CPU server's, and
    ``repair`` re-exports that one shard on the card."""
    from repro_torch.serve import FaultPlan, FaultRule, RetryPolicy

    def kw(dev):
        return dict(fault_plan=FaultPlan([FaultRule("shard_dispatch", rate=1.0,
                                                    match={"shard": 1})], seed=0),
                    retry=RetryPolicy(max_attempts=2, sleep=lambda s: None),
                    breaker_threshold=1, breaker_cooldown_s=1e9)

    pts, (card, cpu) = _sharded_pair(m, kw)
    rng = np.random.default_rng(9)
    c = rng.random((64, 2)).astype(np.float32).astype(np.float64)
    los, his = c - 0.05, c + 0.05
    (gw, gwc), (ww, wwc) = (srv.window(los, his, return_certs=True) for srv in (card, cpu))
    (gk, gkc), (wk, wkc) = (srv.knn(c, 16, return_certs=True) for srv in (card, cpu))
    for a, b in zip(gw + gk, ww + wk):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))
    for x, y in zip(gwc + gkc, wwc + wkc):
        assert (x.complete, x.certified_exact, x.missing_shards) == (
            y.complete, y.certified_exact, y.missing_shards)
    assert any(not x.complete for x in gwc) and card.breakers[1].state == "open"
    assert all(x.missing_shards in ((), (1,)) for x in gwc + gkc)
    exports = card.upload_stats["full_exports"]
    for srv in (card, cpu):
        srv.fault_plan.disarm()
        assert srv.repair() == [1]
    assert card.upload_stats["full_exports"] == exports + 1
    (gw, gwc), (ww, _) = (srv.window(los, his, return_certs=True) for srv in (card, cpu))
    assert all(x.complete for x in gwc)
    for i, (a, b) in enumerate(zip(gw, ww)):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))
        np.testing.assert_array_equal(np.sort(a), _brute_f32(pts, los[i], his[i]))
    assert card.stats == cpu.stats and card.upload_stats == cpu.upload_stats


@pytest.mark.gpu
@pytest.mark.parametrize("m", [2, 4])
def test_sharded_streaming_sync_on_the_card(cuda, m):
    """A sharded streaming server on the card against the same server on
    the CPU and a brute force over the live rows, through syncs that
    re-export changed shards (never a full re-shard)."""
    rng = np.random.default_rng(10)
    pts = rng.random((20_000, 2)).astype(np.float32).astype(np.float64)
    kw = dict(delta_threshold=1024, delta_index_every=256, size_ratio=4)
    card, cpu = (DeviceQueryServer.from_streaming(StreamingIndex(pts, **kw), shards=m,
                                                  microbatch=64, device=dev)
                 for dev in (None, "cpu"))
    assert card.sdev.device.type == "cuda"
    launches.reset()
    for step in range(4):
        ins = rng.random((1024, 2)).astype(np.float32).astype(np.float64)
        ids = [srv.insert(ins) for srv in (card, cpu)]
        dels = rng.choice(ids[0], 16, replace=False)
        assert card.delete(dels) == cpu.delete(dels)
        assert not card._stream_is_stale()
    c = rng.random((64, 2)).astype(np.float32).astype(np.float64)
    los, his = c - 0.01, c + 0.01
    got, want = (srv.window(los, his) for srv in (card, cpu))
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, _live_brute(card.stream, los[i], his[i]))
    got, want = (srv.knn(c, 16) for srv in (card, cpu))
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, _live_knn(card.stream, c[i], 16))
    counts = launches.counts()
    assert all(counts[k] > 0 for k in MAIN_PATH), counts
    assert card.stats == cpu.stats and card.upload_stats == cpu.upload_stats
    assert card.stats.shard_refreshes > 0 and card.stats.stream_reshards == 0
    assert (card.stats.retries, card.stats.host_fallbacks) == (0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("compressed", [False, True])
def test_apply_delta_widening_on_the_card(cuda, compressed):
    """A delta whose new leaves are fuller than every leaf on the card
    pads the old blocks there (f32 max, id -1) and answers as a fresh
    export does."""
    import dataclasses

    pts = np.random.default_rng(3).random((40_000, 2)).astype(np.float32).astype(np.float64)
    ambi = AMBI(pts, 80)
    for c in (0.25, 0.5, 0.75):
        ambi.window(np.full(2, c - 0.02), np.full(2, c + 0.02))
    full = DeviceTable.from_table(ambi.table, pts, partial=True, compressed=compressed)
    counts = full.leaf_counts.cpu().numpy()
    keep = np.flatnonzero(counts < counts.max())
    s = int(counts[keep].max())
    kt = torch.from_numpy(keep).to(cuda)
    old = dataclasses.replace(
        full, leaf_pts=full.leaf_pts[kt, :s].contiguous(),
        leaf_ids=full.leaf_ids[kt, :s].contiguous(), leaf_counts=full.leaf_counts[kt],
        leaf_lo=full.leaf_lo[kt], leaf_hi=full.leaf_hi[kt],
        leaf_lo_c=full.leaf_lo_c[kt] if compressed else None,
        leaf_hi_c=full.leaf_hi_c[kt] if compressed else None,
        n_points=int(counts[keep].sum()), leaf_rows=full.leaf_rows[keep])
    old.host_ids = old.leaf_ids.cpu().numpy()
    dev = old.apply_delta(ambi.table, pts)
    assert dev.device.type == "cuda"
    assert old.leaf_size == s < dev.leaf_size == full.leaf_size
    assert bool((dev.leaf_ids[: len(keep), s:] == -1).all())
    np.testing.assert_array_equal(dev.leaf_ids.cpu().numpy(), dev.host_ids)
    c = np.random.default_rng(4).random((64, 2)).astype(np.float32)
    los, his = c - np.float32(0.03), c + np.float32(0.03)
    launches.reset()
    (gw, gc), (fw, fc) = (window_query_batch_torch(t, los, his, return_cold=True)
                          for t in (dev, full))
    np.testing.assert_array_equal(gc, fc)
    for a, b in zip(gw, fw):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))
    (_, gd), (_, fd) = (knn_query_batch_torch(t, c, 8, return_dists=True)
                        for t in (dev, full))
    for a, b in zip(gd, fd):
        np.testing.assert_array_equal(a, b)
    assert launches.counts()["pair_window_ids"] > 0

def _retrieval_inputs(rng, d, nq=300, npp=700, n=5000, levels=7):
    q = rng.random((nq, d)).astype(np.float32)
    lo = q - np.float32(0.2)
    hi = q + np.float32(0.2)
    gpts = rng.random((nq, npp, d)).astype(np.float32)
    gvalid = (rng.random((nq, npp)) < 0.7).astype(np.int32)
    gpts[gvalid == 0] = F32_MAX
    pts = rng.random((n, d)).astype(np.float32)
    valid = (rng.random(n) < 0.9).astype(np.int32)
    groups = 1 << levels
    split_dim = rng.integers(0, d, (levels, groups)).astype(np.int32)
    split_val = rng.random((levels, groups)).astype(np.float32)
    split_val[:, groups // 2:] = np.inf      # never reached: sanitised to f32 max
    split_val[-1, :4] = np.nan
    return q, lo, hi, gpts, gvalid, pts, valid, split_dim, split_val, levels


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2, 3, 5])
def test_cuda_retrieval_kernels_match_plain(cuda, d):
    q, lo, hi, gpts, gvalid, pts, valid, sdim, sval, levels = _retrieval_inputs(
        np.random.default_rng(40 + d), d)
    cases = [
        (partition_assign.partition_assign,
         lambda *a: ref.partition_assign_ref(*a, levels=levels), (pts, sdim, sval)),
        (window_filter.window_count_gathered, ref.window_count_gathered_ref,
         (lo, hi, gpts, gvalid)),
        (knn_topk.gathered_dist2, ref.gathered_dist2_ref, (q, gpts, gvalid)),
        (knn_topk.pairwise_dist2, ref.pairwise_dist2_ref, (q, pts, valid)),
        (knn_topk.pairwise_dist2, ref.pairwise_dist2_ref, (q[:1], pts, valid)),
    ]
    for kernel, plain, args in cases:
        args = tuple(torch.from_numpy(a).to(cuda) for a in args)
        got = (kernel(*args, levels=levels) if kernel is partition_assign.partition_assign
               else kernel(*args))
        want = plain(*args)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), kernel.__name__


@pytest.mark.gpu
def test_cuda_retrieval_launchers_reject_bad_arguments(cuda):
    f = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=cuda)
    i32 = torch.int32
    with pytest.raises(TypeError):
        partition_assign.partition_assign(f(5, 2), f(3, 4), f(3, 4), levels=3)
    with pytest.raises(ValueError, match="levels"):
        partition_assign.partition_assign(f(5, 2), f(3, 4, dtype=i32), f(3, 4), levels=4)
    with pytest.raises(ValueError, match="groups"):
        partition_assign.partition_assign(f(5, 2), f(3, 2, dtype=i32), f(3, 2), levels=3)
    with pytest.raises(ValueError, match="shape"):
        window_filter.window_count_gathered(f(3, 2), f(3, 2), f(3, 7, 2), f(3, 6, dtype=i32))
    with pytest.raises(ValueError, match="contiguous"):
        knn_topk.gathered_dist2(f(2, 3).t(), f(3, 7, 2), f(3, 7, dtype=i32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        knn_topk.pairwise_dist2(f(3, 2), f(9, 2), f(9, dtype=i32).cpu())
    with pytest.raises(ValueError, match="1 <= d <= 64"):
        knn_topk.pairwise_dist2(f(3, 65), f(9, 65), f(9, dtype=i32))


@pytest.mark.gpu
def test_retrieval_server_on_the_card_matches_the_cpu_server(cuda, tmp_path):
    pts = osm_like(20_000, seed=3)
    launches.reset()
    on_card = RetrievalServer(pts, levels=6, adaptive=True, hot_capacity=8)
    on_cpu = RetrievalServer(pts, levels=6, adaptive=True, hot_capacity=8,
                             device="cpu")
    assert on_card.index.device.type == "cuda"
    for a in on_card.index.ARRAYS:
        assert torch.equal(getattr(on_card.index, a).cpu(), getattr(on_cpu.index, a)), a
    rng = np.random.default_rng(4)
    for _ in range(5):
        qs = (rng.random((16, 2)) * 0.05 + 0.6).astype(np.float32)
        for g, w in zip(on_card.knn(qs, 4), on_cpu.knn(qs, 4)):
            np.testing.assert_array_equal(g, w)
    assert list(on_card.hot) == list(on_cpu.hot) and on_card.stats == on_cpu.stats
    for g, w in zip(on_card.knn_kernel(qs, 5), on_cpu.knn_kernel(qs, 5)):
        np.testing.assert_array_equal(g, w)
    from repro_torch.core import grid_index
    los, his = qs - np.float32(0.05), qs + np.float32(0.05)
    np.testing.assert_array_equal(grid_index.window_count(on_card.index, los, his).cpu(),
                                  grid_index.window_count(on_cpu.index, los, his))
    counts = launches.counts()
    new = ("partition_assign", "window_count_gathered", "pairwise_dist2", "gathered_dist2")
    assert all(counts[k] > 0 for k in new), counts


def _with_non_finite(rng, x):
    """A copy of ``x`` with about one coordinate in 20 set to NaN or +-inf."""
    x = x.copy()
    flat = x.reshape(-1)
    pick = rng.choice(flat.size, size=max(1, flat.size // 20), replace=False)
    flat[pick] = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32), len(pick))
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2, 3, 5, 12])
def test_cuda_window_kernels_match_plain(cuda, d):
    """``window_mask_gathered`` and ``window_count_tiles`` bit for bit
    against their plain versions, with non-finite coordinates, more than
    65,535 mask rows and more windows than one tile of the count (d = 12
    takes the count's path for points too wide for registers)."""
    rng = np.random.default_rng(60 + d)
    q, lo, hi, gpts, gvalid, pts, valid, *_ = _retrieval_inputs(rng, d)
    gpts, pts = _with_non_finite(rng, gpts), _with_non_finite(rng, pts)
    lo[-1], hi[-1] = -np.inf, np.inf
    rows = 70_000
    r_lo = rng.random((rows, d)).astype(np.float32)
    r_hi = r_lo + np.float32(0.5)
    r_pts = rng.random((rows, 3, d)).astype(np.float32)
    r_valid = (rng.random((rows, 3)) < 0.8).astype(np.int32)
    w_lo = rng.random((1100, d)).astype(np.float32) * np.float32(0.7)
    w_hi = w_lo + np.float32(0.3)
    cases = [
        (window_filter.window_mask_gathered, ref.window_mask_gathered_ref,
         (lo, hi, gpts, gvalid)),
        (window_filter.window_mask_gathered, ref.window_mask_gathered_ref,
         (r_lo, r_hi, r_pts, r_valid)),
        (window_filter.window_count_tiles, ref.window_count_ref, (lo, hi, pts, valid)),
        (window_filter.window_count_tiles, ref.window_count_ref, (lo, hi, pts, None)),
        (window_filter.window_count_tiles, ref.window_count_ref,
         (w_lo, w_hi, pts, valid)),
    ]
    for kernel, plain, args in cases:
        args = tuple(None if a is None else torch.from_numpy(a).to(cuda) for a in args)
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype == torch.int32 and got.shape == want.shape
        assert torch.equal(got, want), kernel.__name__


@pytest.mark.gpu
def test_cuda_window_launchers_reject_bad_arguments(cuda):
    f = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=cuda)
    i32 = torch.int32
    with pytest.raises(TypeError):
        window_filter.window_mask_gathered(f(3, 2), f(3, 2), f(3, 7, 2), f(3, 7))
    with pytest.raises(TypeError):
        window_filter.window_count_tiles(f(3, 2, dtype=torch.float64), f(3, 2), f(9, 2))
    with pytest.raises(ValueError, match="shape"):
        window_filter.window_count_tiles(f(3, 2), f(3, 2), f(9, 2), f(8, dtype=i32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        window_filter.window_mask_gathered(f(3, 2), f(3, 2).cpu(), f(3, 7, 2),
                                           f(3, 7, dtype=i32))
    with pytest.raises(ValueError, match="1 <= d <= 64"):
        window_filter.window_count_tiles(f(3, 65), f(3, 65), f(9, 65))
    # zero windows or zero points launch nothing and count nothing
    assert window_filter.window_count_tiles(f(0, 2), f(0, 2), f(9, 2)).shape == (0,)
    assert window_filter.window_count_tiles(f(4, 2), f(4, 2), f(0, 2)).tolist() == [0] * 4


@pytest.mark.gpu
def test_window_count_op_launches_the_tiles_kernel(cuda):
    rng = np.random.default_rng(7)
    pts = torch.from_numpy(rng.random((50_000, 2)).astype(np.float32)).to(cuda)
    lo = torch.from_numpy(rng.random((300, 2)).astype(np.float32) * 0.8).to(cuda)
    hi = lo + 0.2
    launches.reset()
    got = ops.window_count(lo, hi, pts)
    assert launches.counts()["window_count_tiles"] == 1
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), ops.window_count(lo.cpu(), hi.cpu(), pts.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("compressed", [False, True])
def test_unfused_engine_on_the_card_matches_the_plain_engine(cuda, compressed):
    rng = np.random.default_rng(1)
    pts = (rng.random((100_000, 2)) ** 2).astype(np.float32).astype(np.float64)
    idx = bulk_load(pts, 60, PageStore(60))
    on_card = DeviceTable.from_index(idx, compressed=compressed)
    on_cpu = DeviceTable.from_index(idx, compressed=compressed, device="cpu")
    c = rng.random((200, 2)).astype(np.float32)
    los, his = c - np.float32(0.03), c + np.float32(0.03)
    launches.reset()
    got = window_query_batch_torch(on_card, los, his, fused=False)
    for a, b in zip(got, window_query_batch_torch(on_cpu, los, his, fused=False)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, window_query_batch_torch(on_card, los, his, fused=True)):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))
    qs = rng.random((200, 2)).astype(np.float32)
    _, gd, ge = knn_query_batch_torch(on_card, qs, 10, fused=False, n_candidate_leaves=1,
                                      return_dists=True, return_exact=True)
    _, wd, we = knn_query_batch_torch(on_cpu, qs, 10, fused=False, n_candidate_leaves=1,
                                      return_dists=True, return_exact=True)
    np.testing.assert_array_equal(ge, we)
    for a, b in zip(gd, wd):
        np.testing.assert_array_equal(a, b)
    counts = launches.counts()
    assert all(counts[k] > 0 for k in ("box_hits", "window_mask_gathered", "leaf_mindist",
                                       "gathered_dist2")), counts


def _wct_stage(d):
    """Points per stage of ``window_count_tiles`` (``csrc/window_filter.cu``:
    4096 coordinates at the stage's stride, the dimension rounded up to a
    power of two up to 8 and d above, at most 1024, a multiple of 8)."""
    dp = d if d > 8 else 1 << (d - 1).bit_length()
    return min(4096 // dp // 8 * 8, 1024)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 2, 5, 8, 12])
@pytest.mark.parametrize("nq", [1, 33, 1023, 1025, 5000])
def test_window_count_tiles_edge_shapes_match_plain(cuda, d, nq):
    """The redesigned count bit for bit against its plain version: window
    batches that are not a multiple of a block's tile and exceed one tile,
    no point, one, one stage of points and one either side, and enough
    for several stages per block (both stage buffers reused), under a
    validity mask and without, with NaN, infinite and signed-zero points
    and windows with lo > hi, NaN bounds and -0 bounds (the kernel
    compares order-preserving integer keys, -0 keyed as +0)."""
    rng = np.random.default_rng(70 + 7 * d + nq)
    lo = (rng.integers(0, 48, (nq, d)) / 64).astype(np.float32)
    hi = lo + (rng.integers(0, 24, (nq, d)) / 64).astype(np.float32)
    flip = np.flatnonzero(rng.random(nq) < 0.2)
    lo[flip, 0], hi[flip, 0] = hi[flip, 0] + np.float32(1 / 64), lo[flip, 0]
    lo[lo == 0] = -0.0
    hi[(hi == 0) & (rng.random((nq, d)) < 0.5)] = -0.0
    if nq > 2:
        lo[1, -1] = np.nan
        hi[2, 0] = np.nan
    if nq > 1:
        lo[-1], hi[-1] = -np.inf, np.inf
    stage = _wct_stage(d)
    lo_t, hi_t = torch.from_numpy(lo).to(cuda), torch.from_numpy(hi).to(cuda)
    for n_p in (0, 1, stage - 1, stage, stage + 1, 3_000_017):
        pts = (rng.integers(0, 64, (n_p, d)) / 64).astype(np.float32)
        if n_p:
            pts = _with_non_finite(rng, pts)
            pts[(pts == 0) & (rng.random((n_p, d)) < 0.5)] = -0.0
        valid = (rng.random(n_p) < 0.7).astype(np.int32)
        pts_t = torch.from_numpy(pts).to(cuda)
        for v in (torch.from_numpy(valid).to(cuda), None):
            got = window_filter.window_count_tiles(lo_t, hi_t, pts_t, v)
            want = ref.window_count_ref(lo_t, hi_t, pts_t, v)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype == torch.int32 and got.shape == (nq,)
            assert torch.equal(got, want), (n_p, v is None)
            empty = ~(lo <= hi).all(axis=1)
            assert not got[torch.from_numpy(empty).to(cuda)].any()


def _pa_tables(rng, levels, d):
    """Heap-form split tables on the 1/64 grid, with out-of-range split
    dimensions and non-finite split values at reachable entries."""
    groups = 1 << levels
    n_levels = max(levels, 1)
    sdim = rng.integers(-2, d + 2, (n_levels, groups)).astype(np.int32)
    sval = (rng.integers(0, 64, (n_levels, groups)) / 64).astype(np.float32)
    bad = rng.random((n_levels, groups)) < 0.05
    sval[bad] = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32), bad.sum())
    return sdim, sval


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 2, 5, 8, 12])
@pytest.mark.parametrize("levels", [0, 1, 15, 17])
def test_partition_assign_both_paths_match_plain(cuda, d, levels, monkeypatch):
    """Both kernels of ``partition_assign`` bit for bit against the plain
    version: n on either side of ``SMEM_MIN_N`` (the shared-table kernel
    from there up), deeper than the 15 levels in shared memory, and the
    same points forced through each kernel."""
    rng = np.random.default_rng(80 + 3 * d + levels)
    sdim, sval = (torch.from_numpy(a).to(cuda) for a in _pa_tables(rng, levels, d))
    thr = partition_assign.SMEM_MIN_N
    for n in (1, 64, thr - 1, thr, thr + 1, 300_001):
        pts = (rng.integers(0, 64, (n, d)) / 64).astype(np.float32)
        pts[rng.random(n) < 0.01] = np.nan
        pts_t = torch.from_numpy(pts).to(cuda)
        got = partition_assign.partition_assign(pts_t, sdim, sval, levels=levels)
        want = ref.partition_assign_ref(pts_t, sdim, sval, levels=levels)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == (n,)
        assert torch.equal(got, want), n
    for forced in (0, 2**31 - 1):
        monkeypatch.setattr(partition_assign, "SMEM_MIN_N", forced)
        launches.reset()
        got = partition_assign.partition_assign(pts_t, sdim, sval, levels=levels)
        torch.cuda.synchronize()
        assert launches.counts()["partition_assign"] == 1
        assert torch.equal(got, want), forced


def _bh_stage(d):
    """Boxes per shared-memory stage of ``box_hits`` (``csrc/window_filter.cu``:
    4096 floats, one box 2d floats rounded up to a multiple of 4)."""
    return 4096 // ((2 * d + 3) // 4 * 4)


def _bf16_patterns(x):
    """The top 16 bits of f32 ``x`` as bf16: NaN, +-inf and -0 stay so."""
    u = (np.ascontiguousarray(x).view(np.uint32) >> 16).astype(np.uint16)
    return torch.from_numpy(u.view(np.int16)).view(torch.bfloat16)


def _with_edge_values(rng, x):
    """A copy of ``x`` with about one value in 20 set to NaN, +-inf or -0."""
    x = x.copy()
    flat = x.reshape(-1)
    pick = rng.choice(flat.size, size=max(1, flat.size // 20), replace=False)
    flat[pick] = rng.choice(np.array([np.nan, np.inf, -np.inf, -0.0], np.float32), len(pick))
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 2, 5, 8, 12])
@pytest.mark.parametrize("nq", [1, 3, 4, 33, 1023, 1024, 1025])
def test_box_hits_edge_shapes_match_plain(cuda, d, nq):
    """The redesigned box test bit for bit against its plain version: window
    counts that are not a multiple of 4 (the 4-byte store path) and that
    are (one 16-byte store per box), more than one window tile; one box,
    the 204 of an upper level, a shared-memory stage of boxes and one
    either side, and a leaf level of 29,423 (several stages per block
    where a narrow batch gives a block many box lanes); f32 and bf16
    bounds with NaN, +-inf and -0 on both sides, and windows with lo >
    hi.  d = 12 takes the path that reads the windows through L1."""
    rng = np.random.default_rng(90 + 11 * d + nq)
    qlo = (rng.integers(0, 48, (nq, d)) / 64).astype(np.float32)
    qhi = qlo + (rng.integers(0, 24, (nq, d)) / 64).astype(np.float32)
    flip = np.flatnonzero(rng.random(nq) < 0.2)
    qlo[flip, 0], qhi[flip, 0] = qhi[flip, 0] + np.float32(1 / 64), qlo[flip, 0]
    qlo, qhi = _with_edge_values(rng, qlo), _with_edge_values(rng, qhi)
    ql, qh = torch.from_numpy(qlo).to(cuda), torch.from_numpy(qhi).to(cuda)
    stage = _bh_stage(d)
    for n in (1, 204, stage - 1, stage, stage + 1, 29_423):
        lo = (rng.integers(0, 48, (n, d)) / 64).astype(np.float32)
        hi = lo + (rng.integers(0, 16, (n, d)) / 64).astype(np.float32)
        lo, hi = _with_edge_values(rng, lo), _with_edge_values(rng, hi)
        for bounds in ((torch.from_numpy(lo), torch.from_numpy(hi)),
                       (_bf16_patterns(lo), _bf16_patterns(hi))):
            blo, bhi = (b.to(cuda) for b in bounds)
            got = window_filter.box_hits(blo, bhi, ql, qh)
            want = ref.box_hits_tiled_ref(blo, bhi, ql, qh)
            torch.cuda.synchronize()
            assert got.dtype == torch.int32 and got.shape == (n, nq)
            assert torch.equal(got, want), (n, blo.dtype)


def _pair_edge_inputs(rng, d, s, p, nq=50, n_l=40):
    """Pairs over leaves drawn inside their boxes: leaf counts 0, S and
    above S among random ones, padding pairs, boxes that miss their
    window (the exact re-check fails), window 0 unbounded (it holds whole
    leaves) and window 1 equal to leaf 1's box, NaN and +-inf points and
    window bounds; the first pairs take each case."""
    qlo = (rng.integers(0, 48, (nq, d)) / 64).astype(np.float32)
    qhi = qlo + (rng.integers(0, 24, (nq, d)) / 64).astype(np.float32)
    qlo, qhi = _with_edge_values(rng, qlo), _with_edge_values(rng, qhi)
    llo = (rng.integers(0, 48, (n_l, d)) / 64).astype(np.float32)
    lhi = llo + (rng.integers(0, 16, (n_l, d)) / 64).astype(np.float32)
    qlo[0], qhi[0] = -np.inf, np.inf
    qlo[1], qhi[1] = llo[1], lhi[1]
    counts = rng.integers(0, s + 1, n_l).astype(np.int32)
    counts[:4] = [0, s, s + 7, s]
    off = (rng.integers(0, 16, (n_l, s, d)) / 64).astype(np.float32)
    pts = llo[:, None, :] + np.minimum(off, (lhi - llo)[:, None, :])
    pts = _with_non_finite(rng, pts)
    ids = rng.permutation(n_l * s).reshape(n_l, s).astype(np.int32)
    q_idx = rng.integers(0, nq, p).astype(np.int32)
    leaf_idx = rng.integers(0, n_l, p).astype(np.int32)
    pv = (rng.random(p) < 0.7).astype(np.int32)
    head = min(p, 6)
    q_idx[:head] = [0, 0, 1, 0, 0, 2][:head]
    leaf_idx[:head] = [1, 2, 1, 0, 3, 3][:head]
    pv[:head] = [1, 1, 1, 1, 0, 1][:head]
    return qlo, qhi, llo, lhi, pts, ids, counts, q_idx, leaf_idx, pv


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 2, 4, 5, 12])
@pytest.mark.parametrize("s", [1, 17, 170, 341])
def test_pair_window_ids_edge_shapes_match_plain(cuda, d, s):
    """The redesigned pair scan bit for bit against its plain version at
    1, 1,024 and 70,000 pairs (past 65,535 blocks of the parent's grid);
    at d = 2 also on a point table that is not 8-byte aligned (the kernel
    assumes no alignment of a leaf block), and with indices outside their
    tables, which the kernel treats as padding."""
    rng = np.random.default_rng(120 + 13 * d + s)
    for p in (1, 1024, 70_000):
        args = [torch.from_numpy(a).to(cuda) for a in _pair_edge_inputs(rng, d, s, p)]
        tables = [args]
        if d == 2:
            pts = args[4]
            buf = torch.empty(pts.numel() + 1, dtype=torch.float32, device=cuda)
            shifted = buf[1:].view(pts.shape)
            shifted.copy_(pts)
            tables.append(args[:4] + [shifted] + args[5:])
        for a in tables:
            got = window_filter.pair_window_ids(*a)
            want = ref.pair_window_ids_ref(*a)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert g.dtype == torch.int32 and torch.equal(g, w), (p, a[4].data_ptr() % 16)
        # the first pairs: window 0 (unbounded) over leaf 1 (S live slots)
        # and leaf 2 (a count above S), leaf 1's own box over leaf 1, an
        # empty leaf, a padding pair
        pts = a[4].cpu().numpy()
        counts = got[1].cpu().numpy()
        assert counts[0] == (~np.isnan(pts[1]).any(axis=1)).sum()
        if p >= 6:
            assert counts[1] == (~np.isnan(pts[2]).any(axis=1)).sum()
            assert counts[2] == np.isfinite(pts[1]).all(axis=1).sum()
            assert counts[3] == 0 and counts[4] == 0
    # indices outside their tables: padding, as the plain version reads them
    # at (window 0, leaf 0) with pair_valid 0
    a = list(args)
    bad_q, bad_l = a[7].clone(), a[8].clone()
    bad_q[::5], bad_l[1::7] = 50 + 3, -1
    got = window_filter.pair_window_ids(*a[:7], bad_q, bad_l, a[9])
    out = (bad_q >= 50) | (bad_l < 0)
    want = ref.pair_window_ids_ref(*a[:7], torch.where(out, 0, bad_q),
                                   torch.where(out, 0, bad_l), torch.where(out, 0, a[9]))
    torch.cuda.synchronize()
    assert out.any() and all(torch.equal(g, w) for g, w in zip(got, want))
    if s == 1:   # no slots at all: every count 0
        empty = window_filter.pair_window_ids(*a[:4], a[4][:, :0].contiguous(),
                                              a[5][:, :0].contiguous(), *a[6:])
        torch.cuda.synchronize()
        assert empty[0].shape == (70_000, 0) and not empty[1].any()


def _at_odd_offset(t):
    """A copy of ``t`` that starts one element past an aligned buffer."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2, 3, 5])
@pytest.mark.parametrize("s", [1, 31, 32, 33, 341])
def test_pair_dist2_edge_shapes_match_plain(cuda, d, s):
    """The redesigned distance scan bit for bit against its plain version at
    1 to 70,000 pairs (past 65,535 blocks), slot counts around one and two
    warps, leaf counts 0, S and above S among random ones, NaN, +-inf and
    -0 in points and queries, and a leaf table at an odd offset (the
    kernel assumes no alignment of a leaf block).  d = 3 takes the path
    that reads the query through L1.  A pair whose index lies outside its
    table gets f32 max in every slot."""
    rng = np.random.default_rng(200 + 7 * d + s)
    nq, n_l = 60, 40
    q = _with_edge_values(rng, (rng.integers(0, 64, (nq, d)) / 64).astype(np.float32))
    pts = _with_edge_values(rng, (rng.integers(0, 64, (n_l, s, d)) / 64).astype(np.float32))
    counts = rng.integers(0, s + 1, n_l).astype(np.int32)
    counts[:4] = [0, s, s + 7, s // 2]
    qt, pt, ct = (torch.from_numpy(a).to(cuda) for a in (q, pts, counts))
    for p in (1, 7, 64, 8192, 70_000):
        qi = torch.from_numpy(rng.integers(0, nq, p).astype(np.int32)).to(cuda)
        li = torch.from_numpy(rng.integers(0, n_l, p).astype(np.int32)).to(cuda)
        li[:4] = torch.arange(min(p, 4), dtype=torch.int32, device=cuda)
        for table in (pt, _at_odd_offset(pt)):
            got = knn_topk.pair_dist2(qt, table, ct, qi, li)
            want = ref.pair_dist2_ref(qt, table, ct, qi, li)
            torch.cuda.synchronize()
            assert got.dtype == torch.float32 and got.shape == (p, s)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
                p, table.data_ptr() % 16)
    bad_q, bad_l = qi.clone(), li.clone()
    bad_q[::5], bad_l[1::7] = nq + 3, -1
    out = (bad_q >= nq) | (bad_l < 0)
    got = knn_topk.pair_dist2(qt, pt, ct, bad_q, bad_l)
    want = ref.pair_dist2_ref(qt, pt, ct, torch.where(out, 0, bad_q), torch.where(out, 0, bad_l))
    want[out] = float(F32_MAX)
    torch.cuda.synchronize()
    assert out.any() and torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2, 3, 5])
@pytest.mark.parametrize("npp", [1, 3, 4, 5, 39_168])
def test_window_count_gathered_edge_shapes_match_plain(cuda, d, npp):
    """The redesigned count bit for bit against its plain version at 1 to
    1024 windows (one block per window, or a window's slots split over
    several blocks whose counts add atomically): rows with no valid slot,
    every slot valid, and about 6 % valid in runs (the grid index's
    shape), validity words of 0, 1, 2 and -1, NaN, +-inf and -0 in points
    and bounds, windows with lo > hi, points at an odd offset, and a
    validity tensor at an odd offset, which takes the scalar path even
    where npp % 4 == 0 (npp = 1, 3 and 5 always take it).  The scalar path
    and d = 3 run the generic-d code, which keeps the bounds in shared
    memory."""
    g = torch.Generator(device=cuda).manual_seed(300 + 11 * d + npp)
    edges = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0], device=cuda)

    def edge(x):
        pick = torch.rand(x.shape, generator=g, device=cuda) < 0.05
        which = torch.randint(0, 4, x.shape, generator=g, device=cuda)
        return torch.where(pick, edges[which], x)

    for nq in (1, 3, 64, 1024):
        lo = edge(torch.randint(0, 40, (nq, d), generator=g, device=cuda) / 64)
        hi = edge(lo + torch.randint(0, 30, (nq, d), generator=g, device=cuda) / 64)
        flip = torch.rand(nq, generator=g, device=cuda) < 0.2
        lo[flip, 0], hi[flip, 0] = hi[flip, 0] + 1 / 64, lo[flip, 0]
        pts = edge(torch.randint(0, 64, (nq, npp, d), generator=g, device=cuda) / 64)
        kind = torch.arange(nq, device=cuda)[:, None] % 3       # none, all, runs of 6 %
        run = (torch.arange(npp, device=cuda)[None, :] // 341 + kind) % 16 == 0
        word = torch.randint(-1, 3, (nq, npp), generator=g, device=cuda)
        valid = torch.where(kind == 0, torch.zeros_like(word),
                            torch.where(kind == 1, torch.ones_like(word),
                                        torch.where(run, word, 0))).to(torch.int32)
        for p_t, v_t in ((pts, valid), (_at_odd_offset(pts), valid),
                         (pts, _at_odd_offset(valid))):
            got = window_filter.window_count_gathered(lo, hi, p_t, v_t)
            want = ref.window_count_gathered_ref(lo, hi, p_t, v_t)
            torch.cuda.synchronize()
            assert got.dtype == torch.int32 and got.shape == (nq,)
            assert torch.equal(got, want), (nq, p_t.data_ptr() % 16, v_t.data_ptr() % 16)
        if npp == 39_168 and nq == 1024:
            assert want.sum() > 0 and (want[::3] == 0).all()


def _collective_inputs(path, m):
    """``collective_case``'s inputs at a small n: ``osm_like`` points (f32),
    64 queries and windows, two overflowing queries and the stacked layout
    of an FMBI index over the same points at ``m`` shards."""
    rng = np.random.default_rng(41)
    pts = osm_like(20_000, seed=3).astype(np.float32)
    qs = rng.random((64, 2)).astype(np.float32)
    data = {"osm": pts, "osm_qs": qs, "osm_los": qs - np.float32(0.02),
            "osm_his": qs + np.float32(0.02),
            "far_qs": np.array([[2e19, 0.5], [np.inf, 0.5]], dtype=np.float32)}
    idx = bulk_load(pts.astype(np.float64), 60, PageStore(60))
    st = ShardedDeviceTable.from_index(idx, m, device="cpu").stacked()
    data.update({f"stacked.{m}.osm.{key}": v for key, v in st.items()})
    np.savez(path / "inputs.npz", **data)


@pytest.mark.gpu
@pytest.mark.parametrize(("m", "backend"), [(2, "gloo"), (1, "nccl")])
def test_collective_build_and_rounds_match_plain(cuda, tmp_path, m, backend):
    """``shard_build``, ``shard_knn`` and both collective rounds on ranks on
    the card (two gloo ranks sharing it, or an NCCL world of one) equal the
    same ranks on the CPU, where every kernel runs as its plain version;
    the card's ranks launched the kernels of the path, and only gloo
    staged through the host."""
    import collective_ranks as CR

    from repro_torch.core import mesh

    _collective_inputs(tmp_path, m)
    args = (str(tmp_path), ("osm",), ("osm",), 6, 16, 8)
    card = mesh.run_ranks(CR.collective_case, m, backend=backend, devices=["cuda:0"] * m,
                          args=args, timeout=300)
    plain = mesh.run_ranks(CR.collective_case, m, backend="gloo", devices=["cpu"] * m,
                           args=args, timeout=300)
    want = ("leaf_mindist", "gathered_dist2", "window_count_tiles")
    want += ("partition_assign",) if m > 1 else ()
    for c, p in zip(card, plain):
        for key in ("arrays", "knn", "knn_far"):
            for a, b in zip(c["osm"][key], p["osm"][key]):
                assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
        assert c["osm"]["n_dropped"] == p["osm"]["n_dropped"]
        rc, rp = c["rounds"]["osm"], p["rounds"]["osm"]
        assert np.array_equal(rc["window_count"], rp["window_count"])
        for key in ("knn_batch", "knn_batch_far"):
            (dc, ic), (dp, ip) = rc[key], rp[key]
            assert np.array_equal(dc, dp)
            for dq, a, b in zip(dc, ic, ip):   # ids may differ only among ties
                below = dq < dq[-1]
                assert set(a[below].tolist()) == set(b[below].tolist())
        assert all(c["launches"][kk] > 0 for kk in want), c["launches"]
        assert not any(p["launches"].values())
        assert (c["staged_bytes"] > 0) == (backend == "gloo")


@pytest.mark.gpu
def test_knn_serving_twin_runs_on_the_card(cuda):
    """``examples/torch_knn_serving.py`` with its default device: every
    server on the card, every parity it prints holds."""
    import os
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    run = subprocess.run([sys.executable, str(repo / "examples" / "torch_knn_serving.py"),
                          "--n", "50000"], cwd=str(repo), env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "on cuda" in run.stdout
    for line in ("tree-pruned vs kernel distances agree: True",
                 "id-parity vs NumPy engine: windows True, knn True",
                 "id-parity vs single-table engine: windows True, knn True",
                 "bit-identical table: True", "identical to the never-killed twin: True",
                 "id-identical to the offline engine: True"):
        assert line in run.stdout, (line, run.stdout)


@pytest.mark.gpu
@pytest.mark.parametrize("local", [False, True])
def test_lm_generate_on_the_card_matches_the_cpu_port(cuda, local):
    """A reduced dense LM (GQA and qk-norm, or local:global rings with a
    remainder local layer) carried from the CPU to the card: logits within
    1e-4 (float32, TF32 off) and the same greedy tokens."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import LM
    from repro_torch.serve import LMServer

    cfg = ModelConfig(name="t-card", family="dense", n_layers=4 if local else 2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=100,
                      qk_norm=not local, local_window=12 if local else 0,
                      local_per_global=2 if local else 0, dtype="float32", chunk_q=16)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
        card = LM(cfg, device=cuda, empty=True)
        card.load_state_dict(cpu.state_dict())
        prompt = np.random.default_rng(4).integers(0, cfg.vocab, (2, 8))
        np.testing.assert_allclose(card(prompt).cpu().numpy(), cpu(prompt).numpy(),
                                   atol=1e-4, rtol=0)
        np.testing.assert_array_equal(LMServer(card).generate(prompt, 8),
                                      LMServer(cpu).generate(prompt, 8))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["rwkv", "hybrid", "encdec"])
def test_lm_families_on_the_card_match_the_cpu_port(cuda, family):
    """Reduced RWKV6, Mamba/attention/MoE hybrid and encoder-decoder
    models carried from the CPU to the card: full-forward logits within
    1e-4 (float32, TF32 off), prefill plus four decode steps within 1e-4
    of the CPU's, the same experts routed and the same greedy tokens."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import LM
    from repro_torch.serve import LMServer

    common = dict(d_model=64, n_heads=4, d_ff=128, vocab=100, dtype="float32",
                  chunk_q=16)
    cfg = {"rwkv": ModelConfig(name="t-rwkv", family="rwkv", n_layers=2, n_kv_heads=4,
                               head_dim=16, rwkv_head_dim=16, la_chunk=4, **common),
           "hybrid": ModelConfig(name="t-jamba", family="hybrid", n_layers=8, n_kv_heads=2,
                                 n_experts=4, moe_top_k=2, moe_dff=128, moe_every=2,
                                 attn_every=4, mamba_d_state=8, mamba_head_dim=16,
                                 la_chunk=4, **common),
           "encdec": ModelConfig(name="t-encdec", family="encdec", n_layers=2,
                                 encoder_layers=2, n_kv_heads=4, frontend="audio_stub",
                                 **common)}[family]
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, (2, 20))
    extra = ({"frames": rng.normal(0, 1, (2, 24, 64)).astype(np.float32)}
             if family == "encdec" else {})
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
        card = LM(cfg, device=cuda, empty=True)
        card.load_state_dict(cpu.state_dict())
        np.testing.assert_allclose(card(toks, **extra).cpu().numpy(),
                                   cpu(toks, **extra).numpy(), atol=1e-4, rtol=0)
        caches = []
        for lm in (cpu, card):
            last, cache = lm.prefill(toks[:, :16], cache_len=20, **extra)
            steps = [last[:, -1]]
            for t in range(16, 20):
                lg, cache = lm.decode_step(toks[:, t:t + 1], cache, np.full(2, t))
                steps.append(lg[:, 0])
            caches.append(torch.stack(steps).cpu().numpy())
        np.testing.assert_allclose(caches[1], caches[0], atol=1e-4, rtol=0)
        if family == "hybrid":
            x = torch.from_numpy(rng.normal(0, 1, (64, 64)).astype(np.float32))
            np.testing.assert_array_equal(card.layers[1].ffn.route(x.to(cuda))[1].cpu(),
                                          cpu.layers[1].ffn.route(x)[1])
        if family != "encdec":
            np.testing.assert_array_equal(LMServer(card).generate(toks[:, :8], 6),
                                          LMServer(cpu).generate(toks[:, :8], 6))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


# the reduced configs of the training tests on the card: (arch, superblocks)
TRAIN_FAMILIES = {"dense": ("qwen3-0.6b", 2), "local": ("gemma3-27b", 1),
                  "rwkv": ("rwkv6-3b", 2), "hybrid": ("jamba-v0.1-52b", 1),
                  "moe": ("qwen3-moe-235b-a22b", 2), "encdec": ("seamless-m4t-medium", 2),
                  "vlm": ("internvl2-2b", 2)}


def _train_pair(cuda, family, seed=3):
    """A reduced config (d_model 64, vocab 300) as a CPU model and the same
    weights on the card, and a batch of 2 x 32 tokens (with frames or 8
    patches)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import LM

    arch, layers = TRAIN_FAMILIES[family]
    cfg = reduced_config(get_config(arch), layers=layers, d_model=64, vocab=300)
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    card = LM(cfg, device=cuda, empty=True)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.encoder_layers:
        batch["frames"] = rng.normal(0, 1, (2, 32, 64)).astype(np.float32)
    if cfg.frontend == "patch_stub":
        batch["patch_embeds"] = rng.normal(0, 1, (2, 8, 64)).astype(np.float32)
    return cpu, card, batch


@pytest.fixture
def no_tf32():
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = allow


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(TRAIN_FAMILIES))
def test_lm_loss_and_gradients_on_the_card_match_the_cpu_port(cuda, no_tf32, family):
    """``LM.loss`` and every gradient of a reduced model of each family
    on the card against the same weights on the CPU (float32, TF32 off):
    the loss within 1e-5 relative, each gradient within 1e-4 in relative
    L2, the MoE layers' drops counted once and equal."""
    from repro_torch.train.trainer import value_and_grad

    cpu, card, batch = _train_pair(cuda, family)
    (l_cpu, g_cpu), (l_card, g_card) = (value_and_grad(lm, batch) for lm in (cpu, card))
    assert abs(float(l_card) - float(l_cpu)) <= 1e-5 * abs(float(l_cpu))
    for (name, _), a, b in zip(cpu.named_parameters(), g_cpu, g_card):
        err = float((b.cpu().double() - a.double()).norm() / a.double().norm())
        assert err <= 1e-4, (name, err)
    drops = [[int(layer.ffn.dropped) for layer in lm.layers if layer.ffn_kind == "moe"]
             for lm in (cpu, card)]
    assert drops[0] == drops[1]


@pytest.mark.gpu
@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_train_step_on_the_card_matches_the_cpu_port(cuda, no_tf32, opt_name):
    """Two steps (``n_micro = 2``) of the reduced MoE model on the card and
    on the CPU from the same weights: losses and grad norms within 1e-5
    relative, every parameter within 1e-5 in relative L2."""
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.trainer import init_state, make_train_step

    cpu, card, batch = _train_pair(cuda, "moe")
    batch = {k: np.concatenate([v, v[::-1]]) for k, v in batch.items()}
    opt = get_optimizer(opt_name, lr=1e-3)
    runs = []
    for lm in (cpu, card):
        step_fn, state = make_train_step(lm, opt, n_micro=2), init_state(opt, lm)
        ms = []
        for step in range(2):
            state, m = step_fn(state, batch, step)
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append(ms)
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-5)
    for (name, a), b in zip(cpu.named_parameters(), card.parameters()):
        err = float((b.detach().cpu().double() - a.detach().double()).norm()
                    / a.detach().double().norm())
        assert err <= 1e-5, (name, err)


@pytest.mark.gpu
def test_nan_rows_rank_last_on_the_card(cuda):
    """ROADMAP C.7 on the card: the k-NN selections take the smallest
    distances without negating them (a negation on the card drops a NaN's
    sign), so a NaN row is never answered, as on the CPU."""
    rng = np.random.default_rng(0)
    pts = rng.random((4096, 2)).astype(np.float32)
    bad = rng.choice(4096, 10, replace=False)
    pts[bad, 1] = np.nan
    qs = rng.random((16, 2)).astype(np.float32)
    card, host = (RetrievalServer(pts, 6, device=dev) for dev in (cuda, "cpu"))
    for a, b in zip(card.knn(qs, 5), host.knn(qs, 5)):
        assert np.array_equal(a, b)
    for a, b in zip(card.knn_kernel(qs, 5), host.knn_kernel(qs, 5)):
        assert np.array_equal(a, b)
    got_i, got_d = ops.knn_topk(torch.from_numpy(qs).to(cuda), torch.from_numpy(pts).to(cuda), 7)
    want_i, want_d = ops.knn_topk(torch.from_numpy(qs), torch.from_numpy(pts), 7)
    assert torch.equal(got_i.cpu(), want_i) and torch.equal(got_d.cpu(), want_d)
    assert not np.isin(card.knn(qs, 5)[0], bad).any()
    assert not np.isin(got_i.cpu().numpy(), bad).any()
