"""The port's collective build and rounds over a ``torch.distributed``
process group, against the JAX package's ``shard_map`` formulation.

The port runs as gloo ranks on the CPU (``mesh.run_ranks``; the rank
entry functions are in ``collective_ranks.py``, which imports nothing of
JAX or the JAX package).  The JAX package runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (meshes of the
first 1, 4 and 8 devices), as ``tests/test_distributed_jax.py`` and
``tests/test_jax_index.py`` run it.  Both read one ``inputs.npz``; the
JAX side writes ``ref.npz``.  Contract:

  * ``_median_splits``, ``_route_tables``, the nine arrays per shard of
    ``shard_build`` and the columns of ``shard_build_tables``: bit for
    bit at m = 1, 4 and 8, on uniform, gaussian (the reference's seed 5),
    clustered (``cap`` drops points) and grid data;
  * ``shard_knn``: distances at rtol 1e-6 (XLA's CPU compiler contracts
    into FMAs, the port rounds each operation; ROADMAP C.2), rows and
    source shards equal on grid data; every certified answer equals a
    brute force over the kept rows;
  * ``knn_batch_shard_map``: distances at rtol 1e-6 (equal on grid data),
    ids equal except among ties; ``window_count_batch_shard_map``: equal
    to the oracle and the reference;
  * the merge ranks live rows before padding (ROADMAP C.1), and padding
    reads -1 at f32 max;
  * the built shards served through ``ShardedDeviceTable.from_tables``
    answer exactly over the kept rows.
"""
import multiprocessing
import pathlib
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import collective_ranks as CR
from repro.core import distributed as RD
from repro_torch.core import NodeTable, PageStore, ShardedDeviceTable, bulk_load, mesh
from repro_torch.core import distributed as D
from repro_torch.core.datasets import gaussian
from repro_torch.core.distributed_torch import (
    knn_query_batch_sharded,
    window_query_batch_sharded,
)

from engines import f32_points

REPO = pathlib.Path(__file__).resolve().parents[1]
MS = (1, 4, 8)
DATASETS = ("uniform", "gaussian", "clustered", "grid")
PORT_ONLY = ("ragged",)          # m*cap not a multiple of the leaf count at m = 4
# (stacked layout, world size) of the collective rounds: grid data (exact
# arithmetic in both packages) at every m, continuous data at m = 4 as the
# reference's own test runs it
ROUNDS = (("grid", 1), ("grid", 4), ("grid", 8), ("uniform", 4))
LEVELS, K, N_CAND = 4, 8, 8
RANK_TIMEOUT = 120
F32_MAX = np.finfo(np.float32).max


def _clustered(n, seed):
    """Four tight blobs, rows grouped by blob: each rank's slice lies in
    one or two shards' subspaces, so ``cap`` drops points at m = 4 and 8."""
    rng = np.random.default_rng(seed)
    centres = np.array([[0.2, 0.2], [0.8, 0.2], [0.2, 0.8], [0.8, 0.8]])
    pts = centres[np.arange(n) * 4 // n] + 0.02 * rng.standard_normal((n, 2))
    return pts.astype(np.float32)


def _grid_queries(n, seed):
    return (np.random.default_rng(seed).integers(0, 48, (n, 2)) / 64.0).astype(np.float32)


def _inputs(path: pathlib.Path) -> dict:
    rng = np.random.default_rng(3)
    data = {
        "uniform": f32_points(8192, 2, 0).astype(np.float32),
        "gaussian": gaussian(8192, 2, seed=5).astype(np.float32),
        "clustered": _clustered(8192, 9),
        "grid": f32_points(8192, 2, 1, "grid").astype(np.float32),
        "ragged": f32_points(4000, 2, 4).astype(np.float32),
        "far_qs": np.array([[2e19, 0.5], [np.inf, 0.5]], dtype=np.float32),
    }
    for name in DATASETS + PORT_ONLY:
        data[f"{name}_qs"] = (_grid_queries(16, 5) if name == "grid"
                              else rng.random((16, 2)).astype(np.float32))
    for tag, m in ROUNDS:
        centres = data[f"{tag}_qs"]
        data[f"{tag}_los"] = centres - np.float32(0.0625)
        data[f"{tag}_his"] = centres + np.float32(0.0625)
        idx = bulk_load(data[tag].astype(np.float64), 250, PageStore(250))
        st = ShardedDeviceTable.from_index(idx, m, device="cpu").stacked()
        data.update({f"stacked.{m}.{tag}.{key}": v for key, v in st.items()})
    np.savez(path / "inputs.npz", **data)
    return data


JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import numpy as np, jax, jax.numpy as jnp
if len(jax.devices()) < 8:
    print(f"REF-SKIP: only {len(jax.devices())} devices"); sys.exit(0)
from repro.core import distributed
from repro.core.distributed_jax import knn_batch_shard_map, window_count_batch_shard_map
path, levels, k, n_cand = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
datasets, columns = sys.argv[5].split(","), sys.argv[6].split(",")
rounds = [(tag, int(m)) for tag, m in (r.split(":") for r in sys.argv[7].split(","))]
data = np.load(path + "/inputs.npz")
out = {}
for m in (1, 4, 8):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:m]), ("data",))
    # jit once per mesh: an eager shard_map call recompiles every time
    build = jax.jit(lambda p: distributed.shard_build(p, mesh, levels_local=levels))
    knn = jax.jit(lambda so, q: distributed.shard_knn(
        so, q, k, mesh, levels_local=levels, n_candidate_leaves=n_cand))
    for name in datasets:
        so = build(jnp.asarray(data[name]))
        for i, a in enumerate(so):
            out[f"{m}.{name}.build.{i}"] = np.asarray(a)
        for s, t in enumerate(distributed.shard_build_tables(so, levels)):
            for c in columns:
                out[f"{m}.{name}.table.{s}.{c}"] = np.asarray(getattr(t, c))
        for i, a in enumerate(knn(so, jnp.asarray(data[name + "_qs"]))):
            out[f"{m}.{name}.knn.{i}"] = np.asarray(a)
    for tag in [tag for tag, mm in rounds if mm == m]:
        pre = f"stacked.{m}.{tag}."
        st = {key[len(pre):]: data[key] for key in data.files if key.startswith(pre)}
        d2, ids = knn_batch_shard_map(st, data[tag + "_qs"], k, mesh)
        out[f"{m}.{tag}.knn_batch.0"], out[f"{m}.{tag}.knn_batch.1"] = d2, ids
        out[f"{m}.{tag}.window_count"] = window_count_batch_shard_map(
            st, data[tag + "_los"], data[tag + "_his"], mesh)
np.savez(path + "/ref.npz", **out)
print("REF-OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's answers (``None`` where 8 virtual devices could not
    be provisioned) and the port's rank results per world size, computed
    side by side: the reference subprocess runs while the ranks do."""
    path = tmp_path_factory.mktemp("collective")
    data = _inputs(path)
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(path), str(LEVELS), str(K), str(N_CAND),
         ",".join(DATASETS), ",".join(NodeTable.COLUMNS),
         ",".join(f"{tag}:{m}" for tag, m in ROUNDS)],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = {m: mesh.run_ranks(CR.collective_case, m, backend="gloo",
                                  devices=["cpu"] * m, timeout=RANK_TIMEOUT,
                                  args=(str(path), DATASETS + PORT_ONLY,
                                        [tag for tag, mm in ROUNDS if mm == m],
                                        LEVELS, K, N_CAND))
                for m in MS}
        stdout, stderr = ref_proc.communicate(timeout=300)
    finally:
        ref_proc.kill()
    if "REF-OK" in stdout:
        ref = dict(np.load(path / "ref.npz"))
    elif "REF-SKIP" in stdout:
        ref = None
    else:
        raise AssertionError(stdout + stderr)
    return data, ref, port


def _need(ref):
    if ref is None:
        pytest.skip("could not provision 8 virtual devices for the JAX package")
    return ref


def _bitwise_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.kind == "f":
        return np.array_equal(a.view(np.uint8), b.view(np.uint8))
    return np.array_equal(a, b)


def _stacked_build(ranks, name):
    return D.stack_shards([r[name]["arrays"] for r in ranks])


def _kept(ranks, name):
    ri = _stacked_build(ranks, name)[1].ravel()
    return np.sort(ri[ri >= 0])


def _brute_d2(pts32, q):
    """f32 squared distances summed per dimension in the port's order."""
    acc = np.zeros(len(pts32), dtype=np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        for j in range(pts32.shape[1]):
            diff = pts32[:, j] - q[j]
            acc = acc + diff * diff
    return acc


def _check_knn_brute(pts32, rows_kept, q, d2, ids, k):
    """A certified answer equals the brute force over the kept rows: equal
    distance sequence, the distances those of the ids, and equal ids
    where the k-th distance is not tied."""
    full = _brute_d2(pts32[rows_kept], q)
    order = np.argsort(full, kind="stable")
    want = full[order]
    np.testing.assert_array_equal(d2, want[:k])
    np.testing.assert_array_equal(_brute_d2(pts32[ids], q), d2)
    if want[k - 1] < want[k]:
        assert set(ids.tolist()) == set(rows_kept[order[:k]].tolist())


# --------------------------------------------------------------------------
# one process: the central step and the merge
# --------------------------------------------------------------------------
@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("kind", ["uniform", "grid"])
def test_median_splits_and_route_tables_bit_for_bit(levels, kind):
    """Split tables of a gathered sample and the owner route of a point set
    equal the reference's bit for bit, ``+inf`` beyond the groups a level
    uses included (the ``partition_assign`` plain version reads it as f32
    max, which no used group selects)."""
    sample = f32_points(2048, 2, 11 + levels, kind).astype(np.float32)
    pts = np.concatenate([f32_points(3000, 2, 12, kind).astype(np.float32), sample])
    want_dim, want_val = RD._median_splits(jnp.asarray(sample), levels)
    got_dim, got_val = D._median_splits(torch.from_numpy(sample), levels)
    assert _bitwise_equal(got_dim.numpy(), np.asarray(want_dim))
    assert _bitwise_equal(got_val.numpy(), np.asarray(want_val))
    assert np.isinf(got_val.numpy()[0, 1:]).all()
    want = RD._route_tables(jnp.asarray(pts), want_dim, want_val)
    got = D._route_tables(torch.from_numpy(pts), got_dim, got_val)
    assert _bitwise_equal(got.numpy(), np.asarray(want))
    assert got.max() < 1 << levels


def test_merge_ranks_live_rows_before_padding():
    """C.1 through the merge: shard 0's padding (row -1 at +inf, as
    ``grid_index.knn`` reports it, and at f32 max) never outranks shard 1's
    live rows whose distances overflowed to +inf."""
    inf = np.float32(np.inf)
    d2 = torch.tensor([[[1.0, inf, inf, F32_MAX]], [[inf, inf, inf, inf]]])
    rows = torch.tensor([[[7, -1, -1, -1]], [[20, 21, 22, -1]]], dtype=torch.int32)
    got_d2, got_rows, src = D._topk_merge(d2, rows, 6)
    assert got_rows.tolist() == [[7, 20, 21, 22, -1, -1]]
    assert got_d2[0, :4].tolist() == [1.0, inf, inf, inf]
    assert (got_d2[0, 4:] == F32_MAX).all()
    assert src.tolist() == [[0, 1, 1, 1, 0, 0]]


def test_merge_keeps_the_lower_position_among_ties():
    d2 = torch.tensor([[[0.5, 2.0]], [[0.5, 1.0]]])
    rows = torch.tensor([[[3, 4]], [[1, 2]]], dtype=torch.int32)
    got_d2, got_rows, src = D._topk_merge(d2, rows, 3)
    assert got_rows.tolist() == [[3, 1, 2]] and src.tolist() == [[0, 1, 1]]
    assert got_d2.tolist() == [[0.5, 0.5, 1.0]]


# --------------------------------------------------------------------------
# the collective build against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("name", DATASETS)
def test_shard_build_matches_reference(runs, m, name):
    data, ref, port = runs
    ref = _need(ref)
    got = _stacked_build(port[m], name)
    for i, a in enumerate(got):
        assert _bitwise_equal(a, ref[f"{m}.{name}.build.{i}"]), (m, name, i)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("name", DATASETS + PORT_ONLY)
def test_shard_build_keeps_or_drops_every_row_once(runs, m, name):
    """Every input row lands in exactly one shard or is dropped at the
    capacity: the kept rows are distinct and in range, and kept plus
    dropped make n.  Clustered data drops rows at m = 4 and 8."""
    data, _, port = runs
    out = _stacked_build(port[m], name)
    n = len(data[name])
    kept = _kept(port[m], name)
    dropped = sum(r[name]["n_dropped"] for r in port[m])
    assert len(np.unique(kept)) == len(kept) and kept.min() >= 0 and kept.max() < n
    assert int(out[6].sum()) == len(kept) and len(kept) + dropped == n
    assert out[0].shape[1] % (1 << LEVELS) == 0
    if name == "clustered" and m > 1:
        assert dropped > 0
    if m == 1:
        assert dropped == 0


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("name", DATASETS)
def test_shard_build_tables_match_reference(runs, m, name):
    data, ref, port = runs
    ref = _need(ref)
    tables = D.shard_build_tables(_stacked_build(port[m], name), LEVELS)
    assert len(tables) == m
    for s, t in enumerate(tables):
        t.check_invariants()
        for c in NodeTable.COLUMNS:
            assert np.array_equal(getattr(t, c), ref[f"{m}.{name}.table.{s}.{c}"]), (s, c)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("name", ("gaussian", "clustered", "ragged"))
def test_built_tables_serve_the_kept_rows(runs, m, name):
    """``shard_build_tables`` -> ``from_tables`` -> the sharded protocols
    answer exactly over the rows the build kept."""
    data, _, port = runs
    pts32 = data[name]
    kept = _kept(port[m], name)
    tables = D.shard_build_tables(_stacked_build(port[m], name), LEVELS)
    sdev = ShardedDeviceTable.from_tables(tables, pts32.astype(np.float64), device="cpu")
    assert sdev.m == m and sdev.n_points == len(kept)
    qs = data[f"{name}_qs"]
    got = knn_query_batch_sharded(sdev, qs.astype(np.float64), K)
    for q, ids in zip(qs, got):
        _check_knn_brute(pts32, kept, q, _brute_d2(pts32[ids], q), ids, K)
    los, his = qs - np.float32(0.05), qs + np.float32(0.05)
    wins = window_query_batch_sharded(sdev, los.astype(np.float64), his.astype(np.float64))
    inside = np.all((pts32[kept][None] >= los[:, None]) & (pts32[kept][None] <= his[:, None]),
                    axis=2)
    for w, ids in enumerate(wins):
        assert np.array_equal(np.sort(ids), kept[inside[w]])


# --------------------------------------------------------------------------
# k-NN and the collective rounds
# --------------------------------------------------------------------------
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("name", DATASETS)
def test_shard_knn_matches_reference(runs, m, name):
    """Every rank holds the same merged answer; it matches the reference
    (rows and shards equal on grid data) and, where certified, the brute
    force over the kept rows."""
    data, ref, port = runs
    ranks = port[m]
    d2, rows, src, exact = ranks[0][name]["knn"]
    for r in ranks[1:]:
        assert all(_bitwise_equal(a, b) for a, b in zip(r[name]["knn"], (d2, rows, src, exact)))
    kept = _kept(ranks, name)
    qs = data[f"{name}_qs"]
    assert exact.any()
    for i in np.flatnonzero(exact):
        _check_knn_brute(data[name], kept, qs[i], d2[i], rows[i], K)
    ref = _need(ref)
    np.testing.assert_allclose(d2, ref[f"{m}.{name}.knn.0"], rtol=1e-6)
    if name == "grid":
        assert _bitwise_equal(d2, ref[f"{m}.{name}.knn.0"])
        assert _bitwise_equal(rows, ref[f"{m}.{name}.knn.1"])
        assert _bitwise_equal(src, ref[f"{m}.{name}.knn.2"])


@pytest.mark.parametrize(("tag", "m"), ROUNDS)
def test_knn_batch_shard_map_matches_reference(runs, tag, m):
    data, ref, port = runs
    d2, ids = port[m][0]["rounds"][tag]["knn_batch"]
    for r in port[m][1:]:
        assert _bitwise_equal(r["rounds"][tag]["knn_batch"][0], d2)
        assert _bitwise_equal(r["rounds"][tag]["knn_batch"][1], ids)
    pts32 = data[tag]
    every = np.arange(len(pts32))
    for q, dq, iq in zip(data[f"{tag}_qs"], d2, ids):
        _check_knn_brute(pts32, every, q, dq, iq, K)
    ref = _need(ref)
    want_d2, want_ids = ref[f"{m}.{tag}.knn_batch.0"], ref[f"{m}.{tag}.knn_batch.1"]
    np.testing.assert_allclose(d2, want_d2, rtol=1e-6)
    if tag == "grid":
        assert _bitwise_equal(d2, want_d2)
    for dq, iq, wq in zip(d2, ids, want_ids):
        below = dq < dq[-1]   # ids may differ only among ties at the k-th distance
        assert set(iq[below].tolist()) == set(wq[below].tolist())


@pytest.mark.parametrize(("tag", "m"), ROUNDS)
def test_window_count_batch_shard_map_matches_oracle(runs, tag, m):
    data, ref, port = runs
    got = port[m][0]["rounds"][tag]["window_count"]
    assert got.dtype == np.int32
    for r in port[m][1:]:
        assert np.array_equal(r["rounds"][tag]["window_count"], got)
    pts32, los, his = data[tag], data[f"{tag}_los"], data[f"{tag}_his"]
    oracle = np.all((pts32[None] >= los[:, None]) & (pts32[None] <= his[:, None]), axis=2)
    np.testing.assert_array_equal(got, oracle.sum(axis=1))
    assert got.sum() > 0
    ref = _need(ref)
    np.testing.assert_array_equal(got, ref[f"{m}.{tag}.window_count"])


@pytest.mark.parametrize("m", MS)
def test_overflowing_queries_answer_live_rows(runs, m):
    """C.1's queries (every squared distance overflows f32) through
    ``shard_knn`` and ``knn_batch_shard_map``: k distinct dataset rows at
    +inf, never padding."""
    data, _, port = runs
    answers = [port[m][0][name]["knn_far"][:2] for name in DATASETS + PORT_ONLY]
    answers += [port[m][0]["rounds"][tag]["knn_batch_far"] for tag, mm in ROUNDS
                if mm == m]
    for d2, rows in answers:
        assert (rows >= 0).all() and np.isinf(d2).all()
        assert all(len(set(r.tolist())) == K for r in rows)


@pytest.mark.parametrize("m", [4, 8])
def test_ranks_ran_every_collective_on_the_host(runs, m):
    """On the CPU the gloo collectives stage nothing, every span of the
    build is timed, and no kernel launches (the plain versions run)."""
    _, _, port = runs
    for r in port[m]:
        assert r["staged_bytes"] == 0
        assert set(r["seconds"]) == {"sample_gather", "route", "all_to_all", "build"}
        assert not any(r["launches"].values())


# --------------------------------------------------------------------------
# run_ranks: failures surface, nothing is left behind
# --------------------------------------------------------------------------
@pytest.mark.parametrize("how", ["raise", "exit", "hang"])
def test_rank_failure_surfaces(how):
    """Rank 1 raises, exits or hangs while rank 0 waits in a collective:
    the parent raises within the timeout, naming rank 1 (a hang: the
    ranks that gave no result), and no rank process is left."""
    timeout = 20 if how != "hang" else 6
    t0 = time.monotonic()
    expect = TimeoutError if how == "hang" else mesh.RankFailed
    with pytest.raises(expect) as err:
        mesh.run_ranks(CR.fail_in_collective, 2, backend="gloo", devices=["cpu", "cpu"],
                       args=(how,), timeout=timeout)
    assert time.monotonic() - t0 < timeout + 40
    if how == "hang":
        assert "[0, 1]" in str(err.value)
    else:
        assert err.value.rank == 1 and "rank 1" in str(err.value)
    if how == "raise":
        assert "injected rank failure" in str(err.value)
    if how == "exit":
        assert "code 3" in str(err.value)
    assert multiprocessing.active_children() == []


def test_run_ranks_checks_its_arguments():
    with pytest.raises(ValueError, match="backend"):
        mesh.run_ranks(CR.fail_in_collective, 1, backend="mpi", devices=["cpu"])
    with pytest.raises(ValueError, match="devices"):
        mesh.run_ranks(CR.fail_in_collective, 2, backend="gloo", devices=["cpu"])
    with pytest.raises(ValueError, match="NCCL"):
        mesh.run_ranks(CR.fail_in_collective, 1, backend="nccl", devices=["cpu"])
    with pytest.raises(ValueError, match="index"):
        mesh.run_ranks(CR.fail_in_collective, 1, backend="gloo", devices=["cuda"])
