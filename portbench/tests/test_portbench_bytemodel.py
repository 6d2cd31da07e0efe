"""The frozen byte model on shapes counted by hand."""
import torch

from portbench import bytemodel


def test_box_hits_and_leaf_mindist_counts():
    # 10 nodes of 2 x 2 f32 bounds, 3 windows of 2 x 2, 30 one-byte tests
    assert bytemodel.box_hits(10, 2, 3) == 160 + 48 + 30
    # 3 queries of 2 f32, 10 leaf boxes of 16 B, 30 f32 distances
    assert bytemodel.leaf_mindist(10, 2, 3) == 24 + 160 + 120


def test_pair_window_ids_counts_each_used_leaf_once():
    leaf_lo = torch.tensor([[0.0, 0.0], [2.0, 2.0], [5.0, 5.0]])
    leaf_hi = torch.tensor([[1.0, 1.0], [3.0, 3.0], [6.0, 6.0]])
    los = torch.tensor([[0.5, 0.5], [0.9, 0.9]])
    his = torch.tensor([[2.5, 2.5], [2.0, 2.0]])
    hit = bytemodel.intersecting(leaf_lo, leaf_hi, los, his)
    assert hit.tolist() == [[True, True, False], [True, True, False]]
    counts = torch.tensor([4, 7, 9])
    # windows 2 x 16 B; leaves 0 and 1 once: 11 slots x 12 B and 2 boxes x 16 B; 5 ids
    assert bytemodel.pair_window_ids(hit, counts, 2, 5) == 32 + 132 + 32 + 20


def test_pair_dist2_counts_needed_leaves_and_pairs():
    leaf_lo = torch.tensor([[0.0, 0.0], [3.0, 0.0]])
    leaf_hi = torch.tensor([[1.0, 1.0], [4.0, 1.0]])
    qs = torch.tensor([[2.0, 0.5]])
    md = bytemodel.mindist2(leaf_lo, leaf_hi, qs)
    assert md.tolist() == [[1.0, 1.0]]
    need = md <= 1.0
    counts = torch.tensor([5, 6])
    # 1 query x 8 B; 11 slots x 8 B of points; 11 distances x 4 B
    assert bytemodel.pair_dist2(need, counts, 2) == 8 + 88 + 44
