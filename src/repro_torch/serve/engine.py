"""Retrieval server of the PyTorch port: batched exact k-NN over the
balanced grid index, with AMBI's adaptive residency.

The port of ``RetrievalServer`` and ``RetrievalStats`` from the JAX
package's ``repro/serve/engine.py``.  In ``adaptive=True`` mode only the
leaves that the live query stream touches are kept "hot" (the device
analogue of the paper's buffer retention), in an LRU of ``hot_capacity``
leaves, with hit statistics for the workload-adaptation benchmark.  The
index lives on ``device`` (``cuda`` unless the caller names another;
raises without a card).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from ..core import grid_index
from ..core.queries_torch import resolve_device
from ..kernels import ops as kops


@dataclasses.dataclass
class RetrievalStats:
    queries: int = 0
    hot_hits: int = 0
    cold_misses: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hot_hits + self.cold_misses
        return self.hot_hits / total if total else 0.0


class RetrievalServer:
    """Batched exact k-NN over a ``GridIndex`` (CUDA distance kernels).

    Two boot paths: build a balanced index from raw points on the device
    (``__init__``), or bridge a bulk-loaded ``NodeTable`` snapshot straight
    into the grid layout (``from_snapshot``): no rebuild, no re-sort.
    """

    def __init__(self, points: np.ndarray, levels: int, *,
                 adaptive: bool = False, hot_capacity: int = 64, device=None):
        padded, ids = grid_index.pad_points(np.asarray(points).astype(np.float32),
                                            levels)
        self.index = grid_index.build(padded, levels, ids.astype(np.int32),
                                      device=resolve_device(device))
        self._routed = True  # built indexes carry split tables for route()
        self._init_serving(levels, adaptive, hot_capacity)

    @classmethod
    def from_snapshot(cls, path, *, adaptive: bool = False,
                      hot_capacity: int = 64, device=None) -> "RetrievalServer":
        """Boot from a ``NodeTable.save`` snapshot (``.npz`` with points;
        the JAX package's snapshots load too).

        The snapshot's leaf-contiguous layout maps directly onto the grid
        via ``NodeTable.to_grid_index``; adaptive residency locates leaves
        with ``nearest_leaf`` because a bridged FMBI tree has no balanced
        split tables.
        """
        from ..core.nodetable import NodeTable

        dev = resolve_device(device)
        table, _meta, points = NodeTable.load(path)
        if points is None:
            raise ValueError("snapshot was saved without points")
        self = cls.__new__(cls)
        self.index = table.to_grid_index(np.asarray(points)).to(dev)
        self._routed = False
        self._init_serving(self.index.levels, adaptive, hot_capacity)
        return self

    def _init_serving(self, levels: int, adaptive: bool,
                      hot_capacity: int) -> None:
        self.levels = levels
        self.adaptive = adaptive
        # leaf -> last-touch tick, insertion-ordered: recency order IS the
        # dict order, so eviction is popitem(last=False)
        self.hot: OrderedDict[int, int] = OrderedDict()
        self.hot_capacity = hot_capacity
        self.tick = 0
        self.stats = RetrievalStats()

    def _queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(np.asarray(queries, np.float32)).to(self.index.device)

    def knn(self, queries: np.ndarray, k: int, n_candidate_leaves: int = 8):
        """``(row_ids, dists_sq, exact)`` as NumPy arrays; see
        ``grid_index.knn``."""
        q = self._queries(queries)
        rows, d2, exact = grid_index.knn(self.index, q, k,
                                         n_candidate_leaves=n_candidate_leaves)
        if self.adaptive:
            locate = grid_index.route if self._routed else grid_index.nearest_leaf
            for leaf in locate(self.index, q).cpu().tolist():
                self.tick += 1
                if leaf in self.hot:
                    self.stats.hot_hits += 1
                    self.hot.move_to_end(leaf)
                else:
                    self.stats.cold_misses += 1
                self.hot[leaf] = self.tick
                if len(self.hot) > self.hot_capacity:
                    self.hot.popitem(last=False)  # least recent first
            self.stats.queries += len(q)
        return rows.cpu().numpy(), d2.cpu().numpy(), exact.cpu().numpy()

    def knn_kernel(self, queries: np.ndarray, k: int):
        """Brute force over every slot of the grid (distance rows +
        top-k).  Returns ``(idx, dists_sq)``, where ``idx`` indexes
        ``index.points_sorted`` as in the JAX package (map it through
        ``index.row_ids`` for dataset rows)."""
        idx, d2 = kops.knn_topk(
            self._queries(queries), self.index.points_sorted, k,
            valid=(self.index.row_ids >= 0).to(torch.int32),
        )
        return idx.cpu().numpy(), d2.cpu().numpy()
