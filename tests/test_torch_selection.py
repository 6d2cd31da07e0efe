"""The port's selection order (``kernels/ref.py:top_k``) against
``jax.lax.top_k``, and the k-NN entry points that select with it, on NaN
data (ROADMAP C.7).

``lax.top_k`` ranks by the float total order (+NaN > +inf > ... > -inf >
-NaN, +0 before -0), the lower index first among equal values.  A k-NN
caller selects ``top_k(-d2)``, so a NaN distance comes last and padding
(at +inf in the grid index) comes before it.  Contract, against the JAX
package on the same inputs:

  * ``ref.top_k``: values bit for bit and indices equal to ``lax.top_k``'s
    on signed zeros, infinities, NaNs of both signs and ties, and
    ``ref.smallest_k(x)`` equal to ``lax.top_k(-x)`` (the k-NN callers'
    selection, without the negation);
  * 10 NaN rows among 4,096 uniform points: ``RetrievalServer.knn`` rows
    and certificates equal, distances at rtol 1e-6 (ROADMAP C.2);
    ``knn_kernel`` and ``ops.knn_topk`` rows equal, distances equal to a
    float32 brute force and within ``tests/test_kernels.py``'s tolerance
    of the Pallas tiles'; no NaN row is answered;
  * a NaN query whose candidate leaves hold padding (``grid_index.knn``,
    every leaf scanned): padding (-1 at +inf) first, as the reference;
  * ``shard_knn`` over ``shard_build``'s padded shards at m = 2 and 4,
    with NaN rows in the data and a NaN query: equal to the reference
    (the JAX package in a subprocess with forced host devices).
"""
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import collective_ranks as CR
from repro.core import jax_index as JI
from repro.kernels import ops as jops
from repro.serve.engine import RetrievalServer as JaxServer
from repro_torch.core import grid_index as GI
from repro_torch.core import mesh
from repro_torch.kernels import ops, ref
from repro_torch.serve import RetrievalServer

REPO = pathlib.Path(__file__).resolve().parents[1]
F32_MAX = np.finfo(np.float32).max
NEG_NAN = np.array([0xFFC00000], dtype=np.uint32).view(np.float32)[0]


def _bits(x):
    x = np.ascontiguousarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _brute_d2(pts32, q):
    acc = np.zeros(len(pts32), dtype=np.float32)
    for k in range(pts32.shape[1]):
        diff = pts32[:, k] - q[k]
        acc = acc + diff * diff
    return acc


def _edge_values(dtype):
    v = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 0.0, 1.0, -1.0, np.nan,
                  -0.0, 3.0, -np.inf, 1.0, np.inf], dtype=np.float32)
    v[8] = NEG_NAN
    return v.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32])
@pytest.mark.parametrize("order", ["as_is", "reversed", "negated", "shuffled_rows"])
def test_top_k_matches_lax_top_k(dtype, order):
    v = _edge_values(np.float32)
    if order == "reversed":
        v = v[::-1]
    elif order == "negated":
        v = -v
    elif order == "shuffled_rows":
        rng = np.random.default_rng(4)
        v = np.stack([rng.permutation(v) for _ in range(5)])
    if dtype == np.int32:
        v = np.nan_to_num(v, posinf=7, neginf=-7).astype(np.int32)
    else:
        v = v.astype(dtype)
    v = np.ascontiguousarray(v)
    for k in (1, 5, v.shape[-1]):
        want_v, want_i = jax.lax.top_k(jnp.asarray(v), k)
        got_v, got_i = ref.top_k(torch.from_numpy(v), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy().view(np.uint8),
                                      np.asarray(want_v).view(np.uint8))
        # smallest_k(x) is top_k(-x) where the negation keeps a NaN's sign
        neg = np.ascontiguousarray(-v) if dtype != np.int32 else None
        if neg is not None:
            want_v, want_i = jax.lax.top_k(jnp.asarray(neg), k)
            got_v, got_i = ref.smallest_k(torch.from_numpy(v), k)
            np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
            np.testing.assert_array_equal((-got_v).numpy().view(np.uint8),
                                          np.asarray(want_v).view(np.uint8))


def _nan_rows(n=4096, n_nan=10, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2)).astype(np.float32)
    bad = rng.choice(n, n_nan, replace=False)
    pts[bad, 1] = np.nan
    return pts, bad, rng.random((16, 2)).astype(np.float32)


def test_nan_rows_are_never_nearest_in_the_retrieval_server():
    pts, bad, qs = _nan_rows()
    j, t = JaxServer(pts, 6), RetrievalServer(pts, 6, device="cpu")
    rows, d2, exact = t.knn(qs, 5)
    jrows, jd2, jexact = j.knn(qs, 5)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(exact, jexact)
    np.testing.assert_allclose(d2, jd2, rtol=1e-6)
    assert exact.all() and not np.isin(rows, bad).any() and np.isfinite(d2).all()

    idx, kd2 = t.knn_kernel(qs, 5)
    jidx, jkd2 = j.knn_kernel(qs, 5)
    krows = t.index.row_ids.numpy()[idx]
    np.testing.assert_array_equal(krows, np.asarray(j.index.row_ids)[jidx])
    np.testing.assert_allclose(kd2, jkd2, rtol=1e-4, atol=1e-5)
    for i, q in enumerate(qs):
        full = _brute_d2(pts, q)
        np.testing.assert_array_equal(kd2[i], np.sort(full[~np.isnan(full)])[:5])
        np.testing.assert_array_equal(full[krows[i]], kd2[i])
    assert not np.isin(krows, bad).any()


@pytest.mark.parametrize("masked", [False, True])
def test_knn_topk_ranks_nan_distances_last(masked):
    """``ops.knn_topk`` on the NaN rows, and with a validity mask that
    leaves out a quarter of the points (f32 max) and a NaN query."""
    pts, bad, qs = _nan_rows()
    qs = np.concatenate([qs, [[np.nan, 0.5]]]).astype(np.float32)
    valid = (np.arange(len(pts)) % 4 != 0).astype(np.int32) if masked else None
    k = 12
    got_i, got_d = ops.knn_topk(torch.from_numpy(qs), torch.from_numpy(pts), k,
                                valid=None if valid is None else torch.from_numpy(valid))
    want_i, want_d = jops.knn_topk(jnp.asarray(qs), jnp.asarray(pts), k,
                                   valid=None if valid is None else jnp.asarray(valid))
    got_i, got_d = got_i.numpy(), got_d.numpy()
    np.testing.assert_allclose(got_d, np.asarray(want_d), rtol=1e-4, atol=1e-5)
    # the Pallas tiles' rounding may reorder near ties; the NaN query's
    # answer has none
    np.testing.assert_array_equal(got_i[-1], np.asarray(want_i)[-1])
    for i, q in enumerate(qs):
        full = _brute_d2(pts, q)
        if masked:
            full[valid == 0] = F32_MAX
        order = np.argsort(full, kind="stable")[:k]        # NaN sorts last
        np.testing.assert_array_equal(got_i[i], order)
        np.testing.assert_array_equal(_bits(got_d[i]), _bits(full[order]))
    assert not np.isin(got_i[:-1], bad).any()
    if masked:
        # the NaN query: the masked points (f32 max) before any NaN distance
        assert (got_i[-1] % 4 == 0).all() and (got_d[-1] == F32_MAX).all()


def test_nan_query_ranks_padding_before_live_rows():
    """1,024 slots, 256 of them padding, 16 leaves all scanned, k = 80: a
    NaN query answers padding (-1 at +inf), a finite query live rows."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.random((768, 2)).astype(np.float32),
                          np.full((256, 2), F32_MAX, np.float32)])
    ids = np.concatenate([np.arange(768), np.full(256, -1)]).astype(np.int32)
    qs = np.array([[np.nan, 0.5], [0.3, 0.4], [0.5, NEG_NAN]], np.float32)
    jidx = JI.build(jnp.asarray(pts), 4, jnp.asarray(ids))
    tidx = GI.build(pts, 4, ids, device="cpu")
    jrows, jd2, jexact = (np.asarray(a) for a in JI.knn(jidx, jnp.asarray(qs), 80,
                                                         n_candidate_leaves=16))
    rows, d2, exact = (a.numpy() for a in GI.knn(tidx, qs, 80, n_candidate_leaves=16))
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(exact, jexact)
    np.testing.assert_allclose(d2, jd2, rtol=1e-6)      # ROADMAP C.2
    assert (rows[0] == -1).all() and np.isinf(d2[0]).all()
    assert (rows[1] >= 0).all() and np.isfinite(d2[1]).all()


# --------------------------------------------------------------------------
# shard_knn over shard_build's padded shards
# --------------------------------------------------------------------------
LEVELS, K, N_CAND = 3, 8, 8
MS = (2, 4)

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import numpy as np, jax, jax.numpy as jnp
if len(jax.devices()) < 4:
    print(f"REF-SKIP: only {len(jax.devices())} devices"); sys.exit(0)
from repro.core import distributed
path, levels, k, n_cand = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
data = np.load(path + "/inputs.npz")
out = {}
for m in (2, 4):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:m]), ("data",))
    so = distributed.shard_build(jnp.asarray(data["pts"]), mesh, levels_local=levels)
    out[f"{m}.row_ids"] = np.asarray(so[1])
    res = distributed.shard_knn(so, jnp.asarray(data["qs"]), k, mesh, levels_local=levels,
                                n_candidate_leaves=n_cand)
    for i, a in enumerate(res):
        out[f"{m}.knn.{i}"] = np.asarray(a)
np.savez(path + "/ref.npz", **out)
print("REF-OK")
"""


@pytest.fixture(scope="module")
def shard_runs(tmp_path_factory):
    """The JAX package's ``shard_knn`` (in a subprocess) and the port's
    (gloo ranks on the CPU) on the same points, side by side."""
    path = tmp_path_factory.mktemp("nan_shards")
    pts, _, qs = _nan_rows(2048, 6, seed=3)
    qs = np.concatenate([qs[:6], [[np.nan, 0.5], [0.25, np.nan]]]).astype(np.float32)
    np.savez(path / "inputs.npz", pts=pts, qs=qs)
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(path), str(LEVELS), str(K), str(N_CAND)],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = {m: mesh.run_ranks(CR.nan_knn_case, m, backend="gloo", devices=["cpu"] * m,
                                  timeout=120, args=(str(path), LEVELS, K, N_CAND))
                for m in MS}
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        proc.kill()
    if "REF-SKIP" in stdout:
        pytest.skip("could not provision 4 virtual devices for the JAX package")
    assert "REF-OK" in stdout, stdout + stderr
    return pts, qs, dict(np.load(path / "ref.npz")), port


@pytest.mark.parametrize("m", MS)
def test_shard_knn_over_padded_shards_matches_reference(shard_runs, m):
    pts, qs, want, port = shard_runs
    ranks = port[m]
    for r, rank in enumerate(ranks):
        np.testing.assert_array_equal(rank["row_ids"], want[f"{m}.row_ids"][r])
    assert (want[f"{m}.row_ids"] < 0).any()       # the shards hold padding
    d2, rows, src = ranks[0]["knn"]
    for rank in ranks[1:]:
        for a, b in zip(rank["knn"], (d2, rows, src)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(rows, want[f"{m}.knn.1"])
    np.testing.assert_array_equal(src, want[f"{m}.knn.2"])
    # padding reads f32 max in the port, +inf in the reference (ROADMAP C.2)
    live = rows >= 0
    np.testing.assert_allclose(d2[live], want[f"{m}.knn.0"][live], rtol=1e-6)
    assert (d2[~live] == F32_MAX).all() and np.isinf(want[f"{m}.knn.0"][~live]).all()
    # the NaN queries answer padding first; the others no NaN row
    assert not live[6:, 0].any()
    nan_rows = np.flatnonzero(np.isnan(pts).any(axis=1))
    assert live[:6].all() and not np.isin(rows[:6], nan_rows).any()
