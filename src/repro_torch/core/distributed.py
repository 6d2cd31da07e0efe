"""Parallel bulk loading (paper Section 5): the host layer.

``parallel_bulk_load`` is the paper's central-server / m-local-servers
architecture, simulated at page-I/O granularity for the Figure-11
experiments.  The central server partitions a gamma*m page sample into m
subspaces with a SplitTree, streams the remaining points to their owners,
and every local server bulk loads its own FMBI.  The reported cost is the
makespan (slowest server), per Beame et al. [4] as cited by the paper.
``ParallelBuild.merged_table`` ships the m server trees as one table, which
``distributed_torch.ShardedDeviceTable.from_parallel_build`` serves on the
card.

A copy of the host layer of the JAX package's ``repro/core/distributed.py``.
Its device half (``shard_build``, ``shard_knn``, ``gather_topk_merge``: the
build and the k-NN merge as collectives over a device mesh) is not ported
yet; it goes onto ``torch.distributed`` with the device build.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .fmbi import Index, bulk_load
from .nodetable import NodeTable
from .pagestore import IOStats, PageStore, branch_capacity, leaf_capacity
from .splittree import build_group_median_tree


# --------------------------------------------------------------------------
# host-level m-server simulation (Figure 11)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ParallelBuild:
    indexes: list[Index]
    central_io: IOStats
    per_server_io: list[IOStats]
    row_maps: list[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def makespan_io(self) -> int:
        """Parallel cost = slowest local server (paper Section 5)."""
        return max(s.total for s in self.per_server_io) if self.per_server_io else 0

    @property
    def total_io(self) -> int:
        return self.central_io.total + sum(s.total for s in self.per_server_io)

    def merged_table(self) -> NodeTable:
        """Combine the per-server node tables into one global table.

        Local dataset rows are mapped back to global ids through
        ``row_maps`` and each server's page ids are shifted into a single
        flat page namespace, so the result is a shippable snapshot of the
        whole distributed index: a synthetic root over the m server roots
        that any client can query (or ``NodeTable.save``) without touching
        the per-server stores.
        """
        offsets, off = [], 0
        for idx in self.indexes:
            offsets.append(off)
            off += idx.store.allocated_pages
        return NodeTable.merged(
            [idx.table for idx in self.indexes],
            self.row_maps,
            offsets,
            root_page=off,
        )

    def merged_index(self, points: np.ndarray, buffer_pages: int) -> Index:
        """A queryable :class:`Index` over :meth:`merged_table` with a fresh
        (cold) page store — the client-side view of the cluster's index."""
        d = points.shape[1]
        table = self.merged_table()
        store = PageStore(buffer_pages)
        store.mark_allocated(int(table.page_id.max()) + 1)
        return Index(table, d, leaf_capacity(d), branch_capacity(d), store, points)


def parallel_bulk_load(
    points: np.ndarray,
    m: int,
    buffer_pages: int,
    rng: np.random.Generator | None = None,
) -> ParallelBuild:
    """Bulk load FMBI on m servers; each server gets buffer_pages/m pages."""
    rng = rng or np.random.default_rng(0)
    n, d = points.shape
    c_l = leaf_capacity(d)
    central = PageStore(buffer_pages)
    if m == 1:
        store = PageStore(buffer_pages)
        idx = bulk_load(points, buffer_pages, store, rng)
        return ParallelBuild([idx], IOStats(), [store.stats], [np.arange(n)])

    # central server: SplitTree with m-1 splits over a gamma*m page sample
    gamma = max(buffer_pages // m, 1)
    p_total = -(-n // c_l)
    sample_pages = min(gamma * m, p_total)
    need = min(sample_pages * c_l, n)
    perm = rng.permutation(n)
    samp = perm[:need]
    group_pages = max(need // (m * c_l), 1)
    trim = m * group_pages * c_l
    central.read_run(sample_pages)
    tree, _, samp_assign = build_group_median_tree(
        points[samp[:trim]], m, group_pages, c_l
    )
    # stream the rest: the central server reads the remaining pages once
    rest = np.concatenate([samp[trim:], perm[need:]])
    central.read_run(-(-len(rest) // c_l))
    rest_assign = tree.route(points[rest]) if len(rest) else np.zeros(0, np.int32)

    server_buffer = max(buffer_pages // m, branch_capacity(d) + 1)
    indexes, per_io, row_maps = [], [], []
    for s in range(m):
        rows = np.concatenate(
            [samp[:trim][samp_assign == s], rest[rest_assign == s]]
        )
        store = PageStore(server_buffer)
        idx = bulk_load(points[rows], server_buffer, store, rng)
        indexes.append(idx)
        per_io.append(store.stats)
        row_maps.append(rows)
    return ParallelBuild(indexes, central.stats, per_io, row_maps)


def parallel_window_cost(
    build: ParallelBuild, lo: np.ndarray, hi: np.ndarray
) -> tuple[int, int]:
    """(n results, makespan page reads) for one window across servers —
    only qualified servers (subspace intersects the window) are probed."""
    from .geometry import mbb_intersects
    from .queries import window_query

    total, costs = 0, []
    for idx in build.indexes:
        if len(idx.points) == 0 or not mbb_intersects(idx.root.mbb, lo, hi):
            continue
        idx.store.buffer.clear()  # cold per-query cost (comparable across m)
        res, io = window_query(idx, lo, hi)
        total += len(res)
        costs.append(io.total)
    return total, (max(costs) if costs else 0)
