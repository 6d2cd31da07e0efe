"""AMBI and the NumPy engine of the PyTorch port against the JAX package's.

The port keeps its own copies of ``core/ambi.py`` and ``core/queries.py``
(and of the sanitizer's runtime, ``analysis/runtime.py``).  The same
workloads, made from a seed with numpy, drive the port's and the
reference's objects side by side; every result, every ``NodeTable`` column,
the page store's ``IOStats`` and ``AMBI.state_meta()`` must be equal after
every operation.  Both copies run the same float64 NumPy arithmetic, so
the contract is equality, not a tolerance.
"""
import numpy as np
import pytest

from repro.core import AMBI as RefAMBI
from repro.core import PageStore as RefPageStore
from repro.core import bulk_load as ref_bulk_load
from repro.core import queries as RQ
from repro_torch.analysis import runtime as san
from repro_torch.core import AMBI, NodeTable, PageStore, bulk_load
from repro_torch.core import queries as TQ
from repro_torch.serve import DeviceQueryServer
from repro_torch.serve.resilience import TableLock

from engines import f32_points


def _assert_same_state(ref, port):
    for c in NodeTable.COLUMNS:
        assert np.array_equal(getattr(ref.table, c), getattr(port.table, c)), c
    assert (ref.store.stats.reads, ref.store.stats.writes) == (
        port.store.stats.reads, port.store.stats.writes)
    assert ref.state_meta() == port.state_meta()
    assert ref.is_fully_refined() == port.is_fully_refined()


def _workload(rng, d, n_ops):
    """A pinned mix of windows and k-NN queries, half of them around two
    hotspots (the partial-index case) and half spread out."""
    ops = []
    hot = rng.random((2, d)) * 0.6 + 0.2
    for i in range(n_ops):
        c = hot[i % 2] + rng.random(d) * 0.05 if i % 4 < 2 else rng.random(d)
        c = c.astype(np.float32).astype(np.float64)
        if i % 2:
            ops.append(("knn", c, int(rng.integers(1, 40))))
        else:
            w = rng.random(d) * 0.03 + 0.005
            ops.append(("window", c - w, c + w))
    return ops


@pytest.mark.parametrize("kind,d,seed,M", [
    ("uniform", 2, 0, 80),
    ("skew", 2, 1, 80),
    ("uniform", 3, 2, 100),
])
def test_ambi_matches_reference(kind, d, seed, M):
    pts = f32_points(40_000, d, seed, kind)   # more data pages than M
    ref, port = RefAMBI(pts, M), AMBI(pts, M)
    _assert_same_state(ref, port)
    for op in _workload(np.random.default_rng(seed + 50), d, 24):
        if op[0] == "window":
            (want, wio), (got, gio) = ref.window(*op[1:]), port.window(*op[1:])
            assert np.array_equal(np.sort(want), np.sort(got))
            assert np.array_equal(np.sort(got), np.sort(TQ.window_oracle(pts, *op[1:])))
        else:
            (want, wio), (got, gio) = ref.knn(*op[1:]), port.knn(*op[1:])
            assert np.array_equal(want, got)
        assert (wio.reads, wio.writes) == (gio.reads, gio.writes)
        _assert_same_state(ref, port)
    assert not port.is_fully_refined()
    port.table.check_invariants(len(pts))


def test_ambi_state_crosses_between_packages(tmp_path):
    """A port AMBI's table, saved by the port, and its ``state_meta`` boot
    the reference's ``from_table_state`` and the port's: all three then
    refine identically."""
    from repro.core.nodetable import NodeTable as RefTable

    pts = f32_points(25_000, 2, 3)
    port = AMBI(pts, 80)
    for c in (0.3, 0.6):
        port.window(np.full(2, c - 0.02), np.full(2, c + 0.02))
    path = tmp_path / "ambi.npz"
    port.table.save(path)
    ref = RefAMBI.from_table_state(pts, RefTable.load(path)[0], port.state_meta())
    back = AMBI.from_table_state(pts, NodeTable.load(path)[0], port.state_meta())
    for q in (np.array([0.8, 0.1]), np.array([0.45, 0.45])):
        a, b, c = ref.knn(q, 12), back.knn(q, 12), port.knn(q, 12)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[0], c[0])
        assert (a[1].reads, a[1].writes) == (b[1].reads, b[1].writes) == (
            c[1].reads, c[1].writes)
    _assert_same_state(ref, back)
    _assert_same_state(ref, port)


@pytest.mark.parametrize("d,seed", [(2, 4), (4, 5)])
def test_numpy_batch_engines_match_reference(d, seed):
    pts = f32_points(20_000, d, seed)
    ref = ref_bulk_load(pts, 100, RefPageStore(100))
    port = bulk_load(pts, 100, PageStore(100))
    rng = np.random.default_rng(seed)
    c = rng.random((40, d))
    los, his = c - 0.04, c + 0.04
    (rw, rio), (pw, pio) = (RQ.window_query_batch(ref, los, his),
                            TQ.window_query_batch(port, los, his))
    assert (rio.reads, rio.writes) == (pio.reads, pio.writes)
    for a, b, lo, hi in zip(rw, pw, los, his):
        assert np.array_equal(np.sort(a), np.sort(b))
        assert np.array_equal(np.sort(b), np.sort(TQ.window_oracle(pts, lo, hi)))
    (rk, rio), (pk, pio) = (RQ.knn_query_batch(ref, c, 9),
                            TQ.knn_query_batch(port, c, 9))
    assert (rio.reads, rio.writes) == (pio.reads, pio.writes)
    for a, b, q in zip(rk, pk, c):
        assert np.array_equal(a, b)
        assert np.array_equal(TQ.knn_oracle(pts, q, 9), RQ.knn_oracle(pts, q, 9))
    # the single-query forms charge the same reads
    for lo, hi, q in zip(los[:5], his[:5], c[:5]):
        (a, aio), (b, bio) = RQ.window_query(ref, lo, hi), TQ.window_query(port, lo, hi)
        assert np.array_equal(np.sort(a), np.sort(b))
        assert (aio.reads, aio.writes) == (bio.reads, bio.writes)
        (a, aio), (b, bio) = RQ.knn_query(ref, q, 7), TQ.knn_query(port, q, 7)
        assert np.array_equal(a, b)
        assert (aio.reads, aio.writes) == (bio.reads, bio.writes)


@pytest.fixture
def sanitizer():
    prev = san.enable()
    san.reset()
    try:
        yield san
    finally:
        san.reset()
        if not prev:
            san.disable()


def test_sanitizer_guards_grafts_of_a_served_table(sanitizer):
    """With the port's sanitizer on, a graft of a table bound to a
    server's writer lock raises outside the writer section and passes
    inside it; the server's own adaptive path holds the lock."""
    pts = f32_points(40_000, 2, 6)   # 118 data pages > M: refinement is partial
    ambi = AMBI(pts, 80)
    srv = DeviceQueryServer.from_ambi(ambi, microbatch=4, device="cpu")
    lo, hi = np.full(2, 0.4), np.full(2, 0.42)
    before = ambi.table.n_nodes
    with pytest.raises(sanitizer.SanitizerError, match="graft"):
        ambi.window(lo, hi)
    assert ambi.table.n_nodes == before  # raised before any mutation
    with srv.table_lock.write():
        ambi.window(lo, hi)
    assert ambi.table.n_nodes > before
    with pytest.raises(sanitizer.SanitizerError, match="compact"):
        ambi.table.compact()
    got = srv.window(np.array([[0.7, 0.7]]), np.array([[0.72, 0.72]]))
    assert np.array_equal(np.sort(got[0]), TQ.window_oracle(pts, [0.7, 0.7], [0.72, 0.72]))
    assert srv.stats.grafts > 0


def test_sanitizer_catches_lock_reentry(sanitizer):
    lock = TableLock()
    with lock.read():
        with pytest.raises(sanitizer.LockOrderError, match="re-entrant"):
            with lock.write():
                pass
