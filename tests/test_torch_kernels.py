"""The port's kernels against the JAX package's (PyTorch port, kernels 1-4).

On the CPU the port's wrappers run the plain PyTorch versions
(``repro_torch/kernels/ref.py``); these are held against the JAX package's
plain versions (``repro.kernels.ref``, evaluated op by op) and against its
Pallas kernels in interpret mode, on the same numpy inputs.

Tolerances: masks, ids and counts are equal.  ``leaf_mindist`` and
``pair_dist2`` are bitwise equal to the JAX package's op-by-op plain
versions and, on grid data (multiples of 1/64, where every sum is exact),
to the interpreted Pallas kernels.  On continuous data the interpreted
kernels run under XLA's CPU compiler, which contracts ``acc + g * g`` into
a fused multiply-add, so they are held within rtol 1e-6 there.

The CUDA kernels themselves run only on the card: ``tests/test_torch_gpu.py``
(``gpu`` marker) and ``chip_smoke.py`` hold them against the plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.nodetable import compress_boxes_bf16 as compress_ref
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.nodetable import compress_boxes_bf16
from repro_torch.kernels import ops, ref

F32_MAX = np.finfo(np.float32).max


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _coords(rng, shape, grid):
    if grid:
        return (rng.integers(0, 48, shape) / 64.0).astype(np.float32)
    return rng.random(shape).astype(np.float32)


def _boxes(rng, n, d, grid):
    lo = _coords(rng, (n, d), grid)
    ext = _coords(rng, (n, d), grid) * np.float32(0.25)
    return lo, (lo + ext).astype(np.float32)


def _windows(rng, nq, d, grid):
    c = _coords(rng, (nq, d), grid)
    w = _coords(rng, (nq, 1), grid) * np.float32(0.3)
    return (c - w).astype(np.float32), (c + w).astype(np.float32)


def _bounds(lo, hi, bf16):
    """(torch bounds, jax bounds) of one box set: f32, or the outward-rounded
    bf16 copies (the port's uint16 patterns; the JAX package's ml_dtypes)."""
    if not bf16:
        return (_t(lo), _t(hi)), (jnp.asarray(lo), jnp.asarray(hi))
    lo_u, hi_u = compress_boxes_bf16(lo, hi)
    lo_j, hi_j = compress_ref(lo, hi)
    np.testing.assert_array_equal(lo_u, lo_j.view(np.uint16))
    np.testing.assert_array_equal(hi_u, hi_j.view(np.uint16))
    tb = tuple(_t(u.view(np.int16)).view(torch.bfloat16) for u in (lo_u, hi_u))
    return tb, (jnp.asarray(lo_j), jnp.asarray(hi_j))


def _pairs(rng, nq, n_l, p, s):
    q_idx = rng.integers(0, nq, p).astype(np.int32)
    leaf_idx = rng.integers(0, n_l, p).astype(np.int32)
    pair_valid = (rng.random(p) < 0.8).astype(np.int32)
    counts = rng.integers(0, s + 1, n_l).astype(np.int32)
    counts[: max(1, n_l // 4)] = 0                      # empty leaves
    return q_idx, leaf_idx, pair_valid, counts


def _leaf_blocks(rng, n_l, s, d, counts, grid):
    pts = _coords(rng, (n_l, s, d), grid)
    ids = rng.permutation(n_l * s).reshape(n_l, s).astype(np.int32)
    slot = np.arange(s)[None, :]
    pts[slot >= counts[:, None]] = F32_MAX               # padding slots
    ids[slot >= counts[:, None]] = -1
    return pts, ids


def _assert_f32(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# --------------------------------------------------------------------------
# kernel 1: box_hits
# --------------------------------------------------------------------------
@pytest.mark.parametrize("d", [2, 3, 5])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n,nq", [(1, 1), (37, 13), (300, 70)])
def test_box_hits_matches_jax(d, bf16, n, nq):
    rng = np.random.default_rng(n * 10 + nq + d)
    lo, hi = _boxes(rng, n, d, grid=False)
    qlo, qhi = _windows(rng, nq, d, grid=False)
    (tlo, thi), (jlo, jhi) = _bounds(lo, hi, bf16)
    got = ops.box_hits_tiled(tlo, thi, _t(qlo), _t(qhi))
    assert got.dtype == torch.int32 and got.shape == (n, nq)
    np.testing.assert_array_equal(
        got.numpy(), ref.box_hits_tiled_ref(tlo, thi, _t(qlo), _t(qhi)).numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.box_hits_tiled_ref(jlo, jhi, qlo, qhi)))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jops.box_hits_tiled(jlo, jhi, qlo, qhi, interpret=True)))


# --------------------------------------------------------------------------
# kernel 2: pair_window_ids
# --------------------------------------------------------------------------
@pytest.mark.parametrize("d", [2, 3, 5])
@pytest.mark.parametrize("p", [1, 29])
@pytest.mark.parametrize("grid", [False, True])
def test_pair_window_ids_matches_jax(d, p, grid):
    rng = np.random.default_rng(100 + d * 7 + p + grid)
    nq, n_l, s = 9, 11, 17
    qlo, qhi = _windows(rng, nq, d, grid)
    llo, lhi = _boxes(rng, n_l, d, grid)
    q_idx, leaf_idx, pv, counts = _pairs(rng, nq, n_l, p, s)
    pts, ids = _leaf_blocks(rng, n_l, s, d, counts, grid)
    # leaves drawn inside their boxes, so the exact re-check passes for some
    # pairs and fails for others
    pts = np.where(pts < F32_MAX, llo[:, None, :] + (pts * 0.25).astype(np.float32),
                   pts).astype(np.float32)
    args = (qlo, qhi, llo, lhi, pts, ids, counts, q_idx, leaf_idx, pv)
    gi, gc = ops.pair_window_ids(*map(_t, args))
    assert gi.shape == (p, s) and gc.shape == (p,)
    assert gi.dtype == torch.int32 and gc.dtype == torch.int32
    ri, rc = jref.pair_window_ids_ref(*map(jnp.asarray, args))
    ki, kc = jops.pair_window_ids(*map(jnp.asarray, args), interpret=True)
    for want_i, want_c in ((ri, rc), (ki, kc)):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(gc.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(gc.numpy(), (gi.numpy() >= 0).sum(1))


def test_pair_window_ids_invalid_pairs_are_empty():
    rng = np.random.default_rng(3)
    qlo, qhi = np.zeros((2, 2), np.float32), np.ones((2, 2), np.float32)
    llo, lhi = np.zeros((3, 2), np.float32), np.ones((3, 2), np.float32)
    counts = np.array([5, 0, 5], np.int32)
    pts, ids = _leaf_blocks(rng, 3, 5, 2, counts, grid=True)
    q_idx = np.array([0, 1, 1], np.int32)
    leaf_idx = np.array([0, 1, 2], np.int32)
    pv = np.array([0, 1, 1], np.int32)
    gi, gc = ops.pair_window_ids(*map(_t, (qlo, qhi, llo, lhi, pts, ids, counts,
                                            q_idx, leaf_idx, pv)))
    assert gc.tolist() == [0, 0, 5]
    assert (gi[:2] == -1).all() and sorted(gi[2].tolist()) == sorted(ids[2].tolist())


# --------------------------------------------------------------------------
# kernel 4: leaf_mindist (the k-NN candidate ranking)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("d", [2, 3, 5])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("grid", [False, True])
def test_leaf_mindist_matches_jax(d, bf16, grid):
    rng = np.random.default_rng(200 + d + 2 * bf16 + grid)
    nq, n_l = 23, 41
    q = _coords(rng, (nq, d), grid)
    lo, hi = _boxes(rng, n_l, d, grid)
    (tlo, thi), (jlo, jhi) = _bounds(lo, hi, bf16)
    got = ops.leaf_mindist_tiled(_t(q), tlo, thi)
    assert got.dtype == torch.float32 and got.shape == (nq, n_l)
    got = got.numpy()
    _assert_f32(got, ref.leaf_mindist_ref(_t(q), tlo, thi).numpy(), exact=True)
    _assert_f32(got, np.asarray(jref.leaf_mindist_ref(jnp.asarray(q), jlo, jhi)),
                exact=True)
    _assert_f32(got, np.asarray(jops.leaf_mindist_tiled(q, jlo, jhi, interpret=True)),
                exact=grid)
    # the compressed boxes contain the f32 boxes: mindists never grow
    if bf16:
        plain = ref.leaf_mindist_ref(_t(q), _t(lo), _t(hi)).numpy()
        assert np.all(got <= plain)


# --------------------------------------------------------------------------
# kernel 3: pair_dist2
# --------------------------------------------------------------------------
@pytest.mark.parametrize("d", [2, 3, 5])
@pytest.mark.parametrize("p", [1, 31])
@pytest.mark.parametrize("grid", [False, True])
def test_pair_dist2_matches_jax(d, p, grid):
    rng = np.random.default_rng(300 + d * 5 + p + grid)
    nq, n_l, s = 7, 10, 19
    q = _coords(rng, (nq, d), grid)
    q_idx, leaf_idx, _, counts = _pairs(rng, nq, n_l, p, s)
    pts, _ = _leaf_blocks(rng, n_l, s, d, counts, grid)
    args = (q, pts, counts, q_idx, leaf_idx)
    got = ops.pair_dist2(*map(_t, args))
    assert got.dtype == torch.float32 and got.shape == (p, s)
    got = got.numpy()
    _assert_f32(got, ref.pair_dist2_ref(*map(_t, args)).numpy(), exact=True)
    _assert_f32(got, np.asarray(jref.pair_dist2_ref(*map(jnp.asarray, args))),
                exact=grid)
    _assert_f32(got, np.asarray(jops.pair_dist2(*map(jnp.asarray, args),
                                                interpret=True)), exact=grid)
    invalid = np.arange(s)[None, :] >= counts[leaf_idx][:, None]
    assert np.all(got[invalid] == F32_MAX) and np.all(np.isfinite(got))
