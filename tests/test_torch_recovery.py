"""Graft journal, snapshot barriers and crash recovery of the PyTorch port
against the JAX package's.

The reference's scenarios (``tests/test_recovery.py`` and the durability
scenarios of ``tests/test_streaming.py``) run on the port's
``DeviceQueryServer`` with ``device="cpu"``: a killed server reboots from
snapshot + journal replay to the bit-identical table of an uninterrupted
twin.  Journals and snapshots are the same formats in both packages, so a
reference server's files recover in the port (and the recovered server
answers as the reference's live one does), and either package reads the
other's journal.  Only an injected fault is retried: an error of a
journal append or a snapshot write reaches the caller on its first
attempt.
"""
import json
import os
import shutil
import struct
import threading

import numpy as np
import pytest

from repro.core import AMBI as RefAMBI
from repro.serve.engine import DeviceQueryServer as RefServer
from repro.serve.journal import GraftJournal as RefJournal
from repro_torch.core import AMBI, NodeTable, StreamingIndex
from repro_torch.serve import DeviceQueryServer, FaultPlan, FaultRule, RetryPolicy
from repro_torch.serve.faults import FaultError
from repro_torch.serve.journal import GraftJournal, JournalError
from repro_torch.serve.resilience import RetryExhausted

from engines import STREAM_KW, OverlayServerEngine, StreamingServerEngine, f32_points

CPU = "cpu"
_HEADER = struct.Struct("<II")
# 36 data pages >> M=24: refinement is incremental, one record per cold op
_N, _M = 12_000, 24


def _f32(a):
    return np.asarray(a, dtype=np.float32).astype(np.float64)


def _workload(d=2, seed=3, n=10, r=0.03):
    rng = np.random.default_rng(seed)
    c = rng.random((n, d))
    return np.clip(c - r, 0, 1), np.clip(c + r, 0, 1), rng.random((n, d))


def _drive(srv, los, his, qs, k=4):
    out = []
    for i in range(len(los)):
        out.extend(srv.window(los[i:i + 1], his[i:i + 1]))
        out.extend(srv.knn(qs[i:i + 1], k))
    return out


def _record_boundaries(blob):
    offs, off = [0], 0
    while off + _HEADER.size <= len(blob):
        length, _ = _HEADER.unpack_from(blob, off)
        off += _HEADER.size + length
        offs.append(off)
    assert offs[-1] == len(blob)
    return offs


def _adaptive(pts, M, d, **kw):
    d.mkdir(exist_ok=True)
    return DeviceQueryServer.from_ambi(
        AMBI(pts, M), microbatch=8, journal_path=d / "ops.journal",
        snapshot_path=d / "snap.npz", device=CPU, **kw)


def _recover(d, **kw):
    kw.setdefault("microbatch", 8)
    return DeviceQueryServer.recover(d / "snap.npz", d / "ops.journal", device=CPU, **kw)


def _twin_after(pts, M, ops):
    """The uninterrupted twin: a fresh AMBI that executed exactly ``ops``."""
    twin = AMBI(pts, M)
    for rec in ops:
        DeviceQueryServer._replay_op(twin, rec)
    return twin


# --------------------------------------------------------------------------
# the journal, and the snapshot write
# --------------------------------------------------------------------------
def test_journal_roundtrip_and_seq_continuity(tmp_path):
    path = tmp_path / "ops.journal"
    j = GraftJournal(path)
    assert j.append("window", lo=[0.0], hi=[1.0]) == 1
    assert j.append("knn", q=[0.5], k=3) == 2
    j.close()
    recs = list(GraftJournal.read_records(path))
    assert [r["seq"] for r in recs] == [1, 2]
    assert recs[0]["op"] == "window" and recs[1]["k"] == 3
    assert GraftJournal.last_seq(path) == 2
    j2 = GraftJournal(path)
    assert j2.append("compact") == 3
    j2.truncate()
    assert list(GraftJournal.read_records(path)) == []
    assert j2.append("window", lo=[0.0], hi=[0.5]) == 4
    j2.close()
    assert GraftJournal.last_seq(path) == 4


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journals_are_read_by_both_packages(tmp_path, writer):
    path = tmp_path / "ops.journal"
    vals = [0.1, 1 / 3, np.nextafter(0.7, 1.0), 1e-308, 12345.6789012345]
    j = (RefJournal if writer == "reference" else GraftJournal)(path)
    j.append("window", lo=vals, hi=vals)
    j.append("insert", pts=[vals[:2], vals[2:4]])
    j.append("delete", ids=[3, 7])
    j.close()
    blob = path.read_bytes()
    for reader in (RefJournal, GraftJournal):
        recs = list(reader.read_records(path))
        assert [r["op"] for r in recs] == ["window", "insert", "delete"]
        assert np.array_equal(np.asarray(recs[0]["lo"], np.float64), np.asarray(vals))
        assert reader.last_seq(path) == 3
    other = (GraftJournal if writer == "reference" else RefJournal)(path)
    assert other.append("compact") == 4
    other.close()
    assert path.read_bytes()[:len(blob)] == blob


def test_journal_coordinates_roundtrip_exactly(tmp_path):
    path = tmp_path / "ops.journal"
    vals = [0.1, 1 / 3, np.nextafter(0.7, 1.0), 1e-308, 12345.6789012345]
    j = GraftJournal(path)
    j.append("window", lo=vals, hi=vals)
    j.close()
    rec = next(GraftJournal.read_records(path))
    assert np.array_equal(np.asarray(rec["lo"], dtype=np.float64),
                          np.asarray(vals, dtype=np.float64))


def test_journal_torn_tail_tolerated_corruption_fatal(tmp_path):
    path = tmp_path / "ops.journal"
    j = GraftJournal(path)
    for i in range(3):
        j.append("knn", q=[float(i)], k=1)
    j.close()
    blob = path.read_bytes()
    offs = _record_boundaries(blob)
    path.write_bytes(blob[:offs[3] - 1])
    assert [r["seq"] for r in GraftJournal.read_records(path)] == [1, 2]
    path.write_bytes(blob[:offs[2] + 3])
    assert [r["seq"] for r in GraftJournal.read_records(path)] == [1, 2]
    bad = bytearray(blob)
    bad[offs[1] + _HEADER.size + 2] ^= 0xFF
    path.write_bytes(bytes(bad))
    with pytest.raises(JournalError, match="checksum mismatch"):
        list(GraftJournal.read_records(path))
    with pytest.raises(JournalError):
        GraftJournal(path)


def test_snapshot_save_is_atomic(tmp_path):
    pts = f32_points(300, 2, seed=1)
    ambi = AMBI(pts, 64)
    ambi.window(np.zeros(2), np.ones(2))
    path = str(tmp_path / "snap.npz")
    with open(path + ".tmp", "wb") as f:
        f.write(b"garbage from a torn write")
    ambi.table.save(path, points=pts, extra={"v": 1})
    assert not os.path.exists(path + ".tmp")
    table, _meta, loaded = NodeTable.load(path)
    assert table.equals(ambi.table)
    assert np.array_equal(loaded, pts)
    blob = open(path, "rb").read()
    plan = FaultPlan.single("snapshot_save", at_call=1)
    with pytest.raises(FaultError):
        plan.fire("snapshot_save")
    assert open(path, "rb").read() == blob


# --------------------------------------------------------------------------
# write-ahead discipline; errors that are not injected faults
# --------------------------------------------------------------------------
def test_journal_append_failure_fails_the_op(tmp_path):
    pts = f32_points(400, 2, seed=2)
    plan = FaultPlan([FaultRule("journal_append", rate=1.0)])
    srv = _adaptive(pts, 64, tmp_path, fault_plan=plan,
                    retry=RetryPolicy(max_attempts=2, sleep=lambda s: None))
    unref_before = srv.ambi.table.unrefined.copy()
    with pytest.raises(RetryExhausted):
        srv.window(np.zeros((1, 2)), np.ones((1, 2)))
    assert GraftJournal.last_seq(tmp_path / "ops.journal") == 0
    assert np.array_equal(srv.ambi.table.unrefined, unref_before)
    assert srv.stats.retries == 1
    plan.disarm()
    srv.window(np.zeros((1, 2)), np.ones((1, 2)))
    assert srv.journal.seq >= 1 and srv.stats.journal_records >= 1


@pytest.mark.parametrize("stage", ["journal_window", "journal_insert", "snapshot"])
def test_durability_errors_propagate_unretried(tmp_path, monkeypatch, stage):
    """A journal append or a snapshot write that fails with an error that
    is not an injected fault (a full disk) reaches the caller on its first
    attempt, and the op it guards does not run."""
    def broken(*a, **kw):
        raise OSError("no space left on device")

    pts = f32_points(400, 2, seed=3)
    if stage == "journal_window":
        srv = _adaptive(pts, 64, tmp_path)
        unref = srv.ambi.table.unrefined.copy()
        monkeypatch.setattr(GraftJournal, "append", broken)
        with pytest.raises(OSError, match="no space"):
            srv.window(np.zeros((1, 2)), np.ones((1, 2)))
        assert np.array_equal(srv.ambi.table.unrefined, unref)
    elif stage == "journal_insert":
        stream = StreamingIndex(pts, **STREAM_KW)
        srv = DeviceQueryServer.from_streaming(
            stream, journal_path=tmp_path / "ops.journal",
            snapshot_path=tmp_path / "snap.npz", device=CPU)
        monkeypatch.setattr(GraftJournal, "append", broken)
        with pytest.raises(OSError, match="no space"):
            srv.insert(_f32(np.full((3, 2), 0.5)))
        assert stream.n_ids == 400
    else:
        srv = _adaptive(pts, 64, tmp_path)
        monkeypatch.setattr(NodeTable, "save", broken)
        with pytest.raises(OSError, match="no space"):
            srv.checkpoint()
        assert srv.stats.checkpoints == 1   # the boot barrier only
    assert srv.stats.retries == 0 and srv.stats.journal_records == 0


# --------------------------------------------------------------------------
# kill-restart at every journal record boundary
# --------------------------------------------------------------------------
def test_kill_at_every_record_boundary(tmp_path):
    pts = f32_points(_N, 2, seed=7)
    los, his, qs = _workload(n=8)
    live = tmp_path / "live"
    srv = _adaptive(pts, _M, live, compact_slack=1e9)
    _drive(srv, los, his, qs)
    blob = (live / "ops.journal").read_bytes()
    offs = _record_boundaries(blob)
    ops = list(GraftJournal.read_records(live / "ops.journal"))
    assert len(ops) == len(offs) - 1 and len(ops) >= 6
    assert srv.stats.journal_records == len(ops)
    kill = tmp_path / "kill"
    for b in range(len(offs)):
        if kill.exists():
            shutil.rmtree(kill)
        kill.mkdir()
        shutil.copy(live / "snap.npz", kill / "snap.npz")
        (kill / "ops.journal").write_bytes(blob[:offs[b]])
        rec = _recover(kill, compact_slack=1e9)
        twin = _twin_after(pts, _M, ops[:b])
        assert rec.stats.replayed_records == b
        assert rec.ambi.table.equals(twin.table), f"boundary {b}"
        assert rec.ambi.state_meta() == twin.state_meta(), f"boundary {b}"
        if b < len(offs) - 1:
            (kill / "ops.journal").write_bytes(blob[:offs[b] + 3])
            rec2 = _recover(kill, compact_slack=1e9)
            assert rec2.stats.replayed_records == b
            assert rec2.ambi.table.equals(twin.table)


def test_recovered_server_serves_identically(tmp_path):
    pts = f32_points(_N, 2, seed=7)
    los, his, qs = _workload(n=8)
    twin = _adaptive(pts, _M, tmp_path / "twin", compact_slack=1e9)
    dead = _adaptive(pts, _M, tmp_path / "dead", compact_slack=1e9)
    for a, b in zip(_drive(twin, los, his, qs), _drive(dead, los, his, qs)):
        assert np.array_equal(a, b)
    rec = _recover(tmp_path / "dead", compact_slack=1e9)
    assert rec.ambi.table.equals(twin.ambi.table)
    assert rec.journal.seq == twin.journal.seq
    los2, his2, qs2 = _workload(seed=12, n=6)
    base_rec, base_twin = rec.upload_stats.as_dict(), twin.upload_stats.as_dict()
    for a, b in zip(_drive(rec, los2, his2, qs2), _drive(twin, los2, his2, qs2)):
        assert np.array_equal(a, b)
    delta_rec = {k: v - base_rec[k] for k, v in rec.upload_stats.as_dict().items()}
    delta_twin = {k: v - base_twin[k] for k, v in twin.upload_stats.as_dict().items()}
    assert delta_rec == delta_twin
    assert rec.ambi.table.equals(twin.ambi.table)


@pytest.mark.parametrize("seed,frac", [(0, 0.0), (5, 0.35), (211, 0.7), (4099, 1.0)])
def test_kill_restart_at_a_drawn_boundary(tmp_path, seed, frac):
    """The reference's property test at four drawn (seed, boundary) pairs."""
    pts = f32_points(_N, 2, seed=17)
    los, his, qs = _workload(seed=seed, n=5)
    srv = _adaptive(pts, _M, tmp_path, compact_slack=1e9)
    _drive(srv, los, his, qs)
    blob = (tmp_path / "ops.journal").read_bytes()
    offs = _record_boundaries(blob)
    ops = list(GraftJournal.read_records(tmp_path / "ops.journal"))
    b = int(round(frac * (len(offs) - 1)))
    (tmp_path / "ops.journal").write_bytes(blob[:offs[b]])
    rec = _recover(tmp_path, compact_slack=1e9)
    twin = _twin_after(pts, _M, ops[:b])
    assert rec.ambi.table.equals(twin.table)
    assert rec.ambi.state_meta() == twin.state_meta()


# --------------------------------------------------------------------------
# compaction barriers and the snapshot/truncate crash window
# --------------------------------------------------------------------------
def test_compaction_checkpoint_folds_journal_as_the_reference(tmp_path):
    pts = f32_points(_N, 2, seed=9)
    srv = _adaptive(pts, _M, tmp_path / "port", compact_slack=0.05)
    (tmp_path / "ref").mkdir()
    ref = RefServer.from_ambi(RefAMBI(pts, _M), microbatch=8, compact_slack=0.05,
                              journal_path=tmp_path / "ref" / "ops.journal",
                              snapshot_path=tmp_path / "ref" / "snap.npz")
    for w in (_workload(seed=5, n=10), _workload(seed=6, n=10)):
        for a, b in zip(_drive(srv, *w), _drive(ref, *w)):
            assert np.array_equal(a, b)
    assert srv.stats.compactions >= 1 and srv.stats.checkpoints >= 2
    for f in ("compactions", "checkpoints", "journal_records", "grafts"):
        assert getattr(srv.stats, f) == getattr(ref.stats, f), f
    assert srv.journal.seq == ref.journal.seq > 0
    assert (GraftJournal.last_seq(tmp_path / "port" / "ops.journal")
            == RefJournal.last_seq(tmp_path / "ref" / "ops.journal"))
    rec = _recover(tmp_path / "port", compact_slack=0.05)
    assert rec.ambi.table.equals(srv.ambi.table)
    assert rec.ambi.state_meta() == srv.ambi.state_meta()
    assert rec.journal.seq == srv.journal.seq


def test_crash_between_snapshot_and_truncate_replays_nothing_twice(tmp_path):
    pts = f32_points(_N, 2, seed=11)
    srv = _adaptive(pts, _M, tmp_path, compact_slack=1e9)
    _drive(srv, *_workload(seed=8, n=6))
    pre_truncate = (tmp_path / "ops.journal").read_bytes()
    assert len(pre_truncate) > 0
    srv.checkpoint()
    (tmp_path / "ops.journal").write_bytes(pre_truncate)
    rec = _recover(tmp_path, compact_slack=1e9)
    assert rec.stats.replayed_records == 0
    assert rec.ambi.table.equals(srv.ambi.table)
    assert rec.journal.seq == srv.journal.seq


def test_deferred_checkpoint_keeps_compact_in_journal(tmp_path):
    pts = f32_points(_N, 2, seed=13)
    plan = FaultPlan([FaultRule("snapshot_save", rate=1.0)])
    plan.disarm()
    srv = _adaptive(pts, _M, tmp_path, compact_slack=0.05, fault_plan=plan,
                    retry=RetryPolicy(max_attempts=2, sleep=lambda s: None))
    plan.rearm()
    _drive(srv, *_workload(seed=5, n=10))
    if srv.stats.compactions == 0:
        _drive(srv, *_workload(seed=6, n=10))
    assert srv.stats.compactions >= 1 and srv.stats.checkpoints == 1
    ops = list(GraftJournal.read_records(tmp_path / "ops.journal"))
    assert any(r["op"] == "compact" for r in ops)
    plan.disarm()
    rec = _recover(tmp_path, compact_slack=0.05)
    assert rec.ambi.table.equals(srv.ambi.table)
    assert rec.ambi.state_meta() == srv.ambi.state_meta()


def test_recovery_replay_runs_disarmed(tmp_path):
    pts = f32_points(400, 2, seed=4)
    srv = _adaptive(pts, 64, tmp_path, compact_slack=1e9)
    srv.window(np.zeros((1, 2)), np.ones((1, 2)))
    assert srv.journal.seq >= 1
    plan = FaultPlan([FaultRule("host_refine", rate=1.0),
                      FaultRule("pagestore_read", rate=1.0)])
    rec = _recover(tmp_path, compact_slack=1e9, fault_plan=plan)
    assert rec.stats.replayed_records >= 1
    assert plan.total_fires == 0 and plan.armed
    assert rec.ambi.table.equals(srv.ambi.table)


def test_recovery_snapshot_load_fault_is_injectable(tmp_path):
    pts = f32_points(300, 2, seed=6)
    srv = _adaptive(pts, 64, tmp_path)
    srv.window(np.zeros((1, 2)), np.ones((1, 2)))
    plan = FaultPlan.single("snapshot_load", at_call=1)
    with pytest.raises(FaultError):
        _recover(tmp_path, fault_plan=plan)
    rec = _recover(tmp_path, fault_plan=plan)
    assert rec.ambi.table.equals(srv.ambi.table)


# --------------------------------------------------------------------------
# streaming and overlay recovery (the reference's test_streaming.py)
# --------------------------------------------------------------------------
def _ingest_script(eng, seed, rounds):
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        ids = eng.insert(_f32(rng.random((90, 2))))
        eng.delete(rng.integers(0, int(ids[-1]) + 1, size=12))


class _Port:
    """The port's twin of ``engines.StreamingServerEngine`` /
    ``engines.OverlayServerEngine`` (``device="cpu"``)."""

    def __init__(self, pts, overlay=False, **kw):
        if overlay:
            self.srv = DeviceQueryServer.from_ambi(AMBI(pts, 250), microbatch=32,
                                                   device=CPU, **kw)
            self.srv.OVERLAY_KW = dict(STREAM_KW)
        else:
            self.srv = DeviceQueryServer.from_streaming(
                StreamingIndex(pts, **STREAM_KW), microbatch=32, device=CPU, **kw)

    def __getattr__(self, name):
        return getattr(self.srv, name)


def _same_answers(a_srv, b_srv, los, his, qs, k):
    for a, b in zip(a_srv.window(los, his), b_srv.window(los, his)):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))
    for a, b in zip(a_srv.knn(qs, k), b_srv.knn(qs, k)):
        np.testing.assert_array_equal(a, b)


_LOS = np.array([[0.1, 0.2], [0.0, 0.0]])
_HIS = np.array([[0.45, 0.55], [1.0, 1.0]])


def test_streaming_server_recover_replays_ingest(tmp_path):
    pts = f32_points(2000, 2, seed=8)
    live = _Port(pts, journal_path=tmp_path / "ops.journal",
                 snapshot_path=tmp_path / "snap.npz")
    _ingest_script(live, seed=8, rounds=4)
    live.checkpoint()
    _ingest_script(live, seed=88, rounds=3)
    rec = DeviceQueryServer.recover(tmp_path / "snap.npz", tmp_path / "ops.journal",
                                    microbatch=32, device=CPU)
    assert rec.stream is not None and rec.stats.replayed_records == 6
    assert rec.journal.seq == live.journal.seq
    assert rec.stream.n_ids == live.stream.n_ids and rec.stream.shadow == live.stream.shadow
    np.testing.assert_array_equal(rec.stream.live_ids(), live.stream.live_ids())
    _same_answers(rec, live.srv, _LOS, _HIS, f32_points(3, 2, seed=5), 9)


def test_adaptive_overlay_recover(tmp_path):
    pts = f32_points(2500, 2, seed=14)
    live = _Port(pts, overlay=True, journal_path=tmp_path / "ops.journal",
                 snapshot_path=tmp_path / "snap.npz")
    rng = np.random.default_rng(14)
    for _ in range(3):
        c = rng.random(2)
        live.window(c - 0.08, c + 0.08)
    _ingest_script(live, seed=14, rounds=8)
    assert live.stream is not None and live.stream.tiers
    live.checkpoint()
    assert (tmp_path / "snap.stream.npz").exists()
    for _ in range(2):
        c = rng.random(2)
        live.window(c - 0.08, c + 0.08)
    _ingest_script(live, seed=15, rounds=2)
    rec = DeviceQueryServer.recover(tmp_path / "snap.npz", tmp_path / "ops.journal",
                                    microbatch=32, device=CPU)
    rec.OVERLAY_KW = dict(STREAM_KW)
    assert rec.stream is not None and rec.stream.n_ids == live.stream.n_ids
    np.testing.assert_array_equal(rec.stream.live_ids(), live.stream.live_ids())
    assert rec.ambi.table.equals(live.ambi.table)
    _same_answers(rec, live.srv, np.array([[0.15, 0.15], [0.0, 0.0]]),
                  np.array([[0.5, 0.6], [1.0, 1.0]]), f32_points(3, 2, seed=15), 7)


def test_journal_order_matches_application_order_under_races(tmp_path):
    pts = f32_points(800, 2, seed=31)
    live = _Port(pts, journal_path=tmp_path / "ops.journal",
                 snapshot_path=tmp_path / "snap.npz")
    live.checkpoint()

    def writer(t):
        rng = np.random.default_rng(100 + t)
        for _ in range(20):
            batch = rng.random((25, 2))
            batch[:, 0] = (batch[:, 0] + t) / 2.0
            live.insert(batch)

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    rec = DeviceQueryServer.recover(tmp_path / "snap.npz", tmp_path / "ops.journal",
                                    microbatch=32, device=CPU)
    n = live.stream.n_ids
    assert rec.stream.n_ids == n == 1800
    np.testing.assert_array_equal(rec.stream.points[:n], live.stream.points[:n])


def test_out_of_range_delete_rejected_before_journaling(tmp_path):
    pts = f32_points(900, 2, seed=7)
    live = _Port(pts, journal_path=tmp_path / "ops.journal",
                 snapshot_path=tmp_path / "snap.npz")
    live.checkpoint()
    _ingest_script(live, seed=7, rounds=2)
    bad = live.stream.n_ids + 1000
    with pytest.raises(IndexError):
        live.delete([bad])
    _ingest_script(live, seed=77, rounds=1)
    for r in GraftJournal.read_records(tmp_path / "ops.journal"):
        if r["op"] == "delete":
            assert bad not in r["ids"]
    rec = DeviceQueryServer.recover(tmp_path / "snap.npz", tmp_path / "ops.journal",
                                    microbatch=32, device=CPU)
    np.testing.assert_array_equal(rec.stream.live_ids(), live.stream.live_ids())


def test_sidecar_crash_between_saves_loses_no_ingest(tmp_path, monkeypatch):
    pts = f32_points(2500, 2, seed=14)
    live = _Port(pts, overlay=True, journal_path=tmp_path / "ops.journal",
                 snapshot_path=tmp_path / "snap.npz",
                 retry=RetryPolicy(max_attempts=2, sleep=lambda s: None))
    _ingest_script(live, seed=14, rounds=8)
    live.checkpoint()
    _ingest_script(live, seed=15, rounds=2)
    real_save = StreamingIndex.save

    def torn_save(self, path, extra=None):
        raise FaultError("snapshot_save", 1, {"where": "between base and sidecar"})

    monkeypatch.setattr(StreamingIndex, "save", torn_save)
    with pytest.raises(RetryExhausted):
        live.checkpoint()
    monkeypatch.setattr(StreamingIndex, "save", real_save)
    rec = DeviceQueryServer.recover(tmp_path / "snap.npz", tmp_path / "ops.journal",
                                    microbatch=32, device=CPU)
    assert rec.stream is not None and rec.stream.n_ids == live.stream.n_ids
    np.testing.assert_array_equal(rec.stream.live_ids(), live.stream.live_ids())
    _same_answers(rec, live.srv, np.array([[0.15, 0.15], [0.0, 0.0]]),
                  np.array([[0.5, 0.6], [1.0, 1.0]]), f32_points(3, 2, seed=16), 5)


# --------------------------------------------------------------------------
# across the packages: a reference server's files recover in the port
# --------------------------------------------------------------------------
def test_reference_streaming_server_recovers_in_the_port(tmp_path):
    """A reference streaming server, killed (dropped without a barrier)
    after a checkpoint and more ingest: its stream snapshot and journal
    recover in the port, which replays exactly the journaled ops and
    answers as the live reference server does."""
    pts = f32_points(2000, 2, seed=8)
    live = StreamingServerEngine(pts, journal_path=tmp_path / "ops.journal",
                                 snapshot_path=tmp_path / "snap.npz")
    _ingest_script(live, seed=8, rounds=4)
    live.srv.checkpoint()
    _ingest_script(live, seed=88, rounds=3)
    n_journal = len(list(RefJournal.read_records(tmp_path / "ops.journal")))
    rec = DeviceQueryServer.recover(tmp_path / "snap.npz", tmp_path / "ops.journal",
                                    microbatch=32, device=CPU)
    assert rec.stats.replayed_records == n_journal == 6
    assert rec.journal.seq == live.srv.journal.seq
    assert rec.stream.n_ids == live.stream.n_ids and rec.stream.shadow == live.stream.shadow
    np.testing.assert_array_equal(rec.stream.points, live.stream.points)
    np.testing.assert_array_equal(rec.stream.live_ids(), live.stream.live_ids())
    _same_answers(rec, live.srv, _LOS, _HIS, f32_points(4, 2, seed=5), 9)
    # the recovered port server keeps journaling where the reference stopped
    batch = _f32(np.random.default_rng(1).random((40, 2)))
    np.testing.assert_array_equal(rec.insert(batch), live.insert(batch))
    assert rec.journal.seq == live.srv.journal.seq
    _same_answers(rec, live.srv, _LOS, _HIS, f32_points(4, 2, seed=6), 9)


def _same_adaptive_state(a, b):
    """Equal AMBI state (``state_meta``) but for the page store's LRU
    buffer and reads: buffer size, rng, allocator and writes.  Queries of
    the streaming overlay read pages of the shared store without a journal
    record, so no replay reproduces the buffer or the reads that follow
    from it (ROADMAP C.5)."""
    sa, sb = json.loads(a.state_meta()), json.loads(b.state_meta())
    for s in (sa, sb):
        del s["store"]["reads"], s["store"]["buffer_pages"]
    assert sa == sb


def test_reference_adaptive_server_recovers_in_the_port(tmp_path):
    """The same for an adaptive reference server with cold-op records, a
    compaction barrier and an overlay sidecar; after the barrier the
    overlay flushes before cold ops graft, so the two draw page ids from
    the one page store they share.  The port's recovered AMBI table,
    adaptive state and overlay equal the live reference's."""
    pts = f32_points(_N, 2, seed=19)
    live = OverlayServerEngine(pts, M=_M, journal_path=tmp_path / "ops.journal",
                               snapshot_path=tmp_path / "snap.npz")
    live.srv.compact_slack = 0.05
    _drive(live.srv, *_workload(seed=5, n=6))
    _ingest_script(live, seed=19, rounds=7)
    assert live.srv.stats.compactions >= 1
    live.srv.checkpoint()
    live.srv.compact_slack = 1e9   # no barrier after this one
    _ingest_script(live, seed=20, rounds=7)
    _drive(live.srv, *_workload(seed=6, n=4))
    rec = DeviceQueryServer.recover(tmp_path / "snap.npz", tmp_path / "ops.journal",
                                    microbatch=32, compact_slack=1e9, device=CPU)
    rec.OVERLAY_KW = dict(STREAM_KW)
    assert rec.stats.replayed_records > 0
    assert rec.stream.store is rec.ambi.store
    for c in NodeTable.COLUMNS:
        assert np.array_equal(getattr(rec.ambi.table, c), getattr(live.srv.ambi.table, c)), c
    _same_adaptive_state(rec.ambi, live.srv.ambi)
    assert rec.journal.seq == live.srv.journal.seq
    assert [t.tid for t in rec.stream.tiers] == [t.tid for t in live.srv.stream.tiers]
    for a, b in zip(rec.stream.tiers, live.srv.stream.tiers):
        for c in NodeTable.COLUMNS:
            assert np.array_equal(getattr(a.table, c), getattr(b.table, c)), c
    np.testing.assert_array_equal(rec.stream.live_ids(), live.srv.stream.live_ids())
    np.testing.assert_array_equal(rec.stream.points, live.srv.stream.points)
    los, his, qs = _workload(seed=21, n=6)
    _same_answers(rec, live.srv, _f32(los), _f32(his), _f32(qs), 6)
    for c in NodeTable.COLUMNS:
        assert np.array_equal(getattr(rec.ambi.table, c), getattr(live.srv.ambi.table, c)), c
