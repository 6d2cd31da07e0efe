"""The port's CUDA kernels and engine on the card (``gpu`` marker).

Imports only torch, numpy and the port, so it collects on a machine with
a card and no JAX:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card every test skips (the decision is taken inside the fixture,
not at import).  Each kernel is held bit for bit against its plain version
on the same CUDA tensors, and the engine's answers on a ``cuda`` export
against the same export on the CPU (where every kernel runs as its plain
version).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (
    DeviceTable,
    PageStore,
    bulk_load,
    compress_boxes_bf16,
    knn_query_batch_torch,
    window_query_batch_torch,
)
from repro_torch.kernels import knn_topk, launches, ref, window_filter

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
    assert all(counts[k] > 0 for k in launches.KERNELS), counts
