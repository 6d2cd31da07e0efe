"""k-NN when squared distances overflow: live points rank before padding
(PyTorch port, ``core/queries_torch.py:_knn_merge``).

A query far enough out overflows every live squared distance to ``+inf``.
A padding slot holds f32 max, which is smaller, so a merge that ranks raw
distances answers "no point" (id -1) while the table holds points, and a
certificate that compares raw distances certifies padding against an
unscanned mindist of ``+inf``.  The port ranks live slots first (``+inf``
included), then padding, then NaN distances, on both engines and both
exports; these tests hold it to that.

The table is FMBI over ``f32_points(4000, 2, 1)`` with M = 120: 12 leaves,
the last holding 249 of its 341 slots.  Contract: the distance sequences
equal a float32 brute force summed per dimension in the kernels' order
(the NumPy oracle's rows give the same sequence), ids are distinct dataset
rows, and where the JAX engine answers with live rows its distances are
equal too.  On the scaled table below every JAX path returns padding: the
reference certifies padding there, a fault the port does not copy.
"""
import numpy as np
import pytest

from repro.core import knn_oracle
from repro.core.queries_jax import DeviceTable as JaxTable
from repro.core.queries_jax import knn_query_batch_jax
from repro_torch.core import DeviceTable, PageStore, bulk_load, knn_query_batch_torch

from engines import build_fmbi, f32_points

M = 120
F32_MAX = np.finfo(np.float32).max
SCALE = 2.0**60   # exact in f32: the scaled table has the same leaves


def _brute_d2(pts32, q):
    acc = np.zeros(len(pts32), dtype=np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        for k in range(pts32.shape[1]):
            diff = pts32[:, k] - q[k]
            acc = acc + diff * diff
    return acc


def _tables(scale, compressed):
    pts = f32_points(4000, 2, 1) * scale
    port = DeviceTable.from_index(bulk_load(pts, M, PageStore(M)),
                                  compressed=compressed, device="cpu")
    assert port.n_leaves == 12 and port.leaf_counts[-1] == 249
    jax_dev = JaxTable.from_index(build_fmbi(pts, M), compressed=compressed)
    return pts, port, jax_dev


# name -> (scale of the points, query, k, candidate leaves of the first round)
CASES = {
    # every live distance overflows, every mindist too
    "overflow": (1.0, [2e19, 0.5], 3, None),
    "inf_coordinate": (1.0, [np.inf, 0.5], 3, None),
    # only the part-filled leaf 11 has a finite mindist: the first round
    # scans it alone (249 live slots, 51 padding slots in the top 300), and
    # the certificate must escalate instead of certifying padding against
    # the other leaves' +inf mindists
    "padding_escalates": (SCALE, [SCALE + 1.3e19] * 2, 300, 1),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_knn_live_points_rank_before_padding(fused, compressed, case):
    scale, q, k, n_cand = CASES[case]
    pts, port, jax_dev = _tables(scale, compressed)
    pts32 = pts.astype(np.float32)
    qs = np.array([q], dtype=np.float32)
    ids, d2, exact = knn_query_batch_torch(
        port, qs, k, fused=fused, n_candidate_leaves=n_cand,
        return_dists=True, return_exact=True)
    ids, d2 = ids[0], d2[0]
    full = _brute_d2(pts32, qs[0])
    want = np.sort(full, kind="stable")[:k]
    assert len(ids) == k and (ids >= 0).all(), ids
    assert len(set(ids.tolist())) == k and (ids < len(pts)).all()
    np.testing.assert_array_equal(d2, want)
    np.testing.assert_array_equal(full[ids], d2)
    np.testing.assert_array_equal(full[knn_oracle(pts, qs[0], k)], want)
    assert exact[0]
    if case == "padding_escalates":
        assert np.isfinite(d2).sum() == 11 and np.isinf(d2[11:]).all()
        # the nearest live points of leaf 11, then rows of other leaves
        finite = np.flatnonzero(np.isfinite(full))
        assert set(ids[:11].tolist()) == set(finite.tolist())
    else:
        assert np.isinf(d2).all()
        _, jd2 = knn_query_batch_jax(jax_dev, qs, k, return_dists=True)
        np.testing.assert_array_equal(d2, jd2[0])


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_knn_nan_query_answers_padding(fused, compressed):
    """A NaN query's distances are NaN and rank after padding: the answer
    stays id -1 at f32 max, the JAX kernel path's (``use_kernel=True``)."""
    _, port, jax_dev = _tables(1.0, compressed)
    qs = np.array([[np.nan, 0.5]], dtype=np.float32)
    ids, d2 = knn_query_batch_torch(port, qs, 3, fused=fused, return_dists=True)
    np.testing.assert_array_equal(ids[0], [-1, -1, -1])
    np.testing.assert_array_equal(d2[0], [F32_MAX] * 3)
    jids, jd2 = knn_query_batch_jax(jax_dev, qs, 3, use_kernel=True, return_dists=True)
    np.testing.assert_array_equal(ids[0], jids[0])
    np.testing.assert_array_equal(d2[0], jd2[0])
