"""Parallel bulk loading and distributed query processing (paper Section 5).

``parallel_bulk_load`` is the paper's central-server / m-local-servers
architecture, simulated at page-I/O granularity for the Figure-11
experiments.  The central server partitions a gamma*m page sample into m
subspaces with a SplitTree, streams the remaining points to their owners,
and every local server bulk loads its own FMBI.  The reported cost is the
makespan (slowest server), per Beame et al. [4] as cited by the paper.
``ParallelBuild.merged_table`` ships the m server trees as one table, which
``distributed_torch.ShardedDeviceTable.from_parallel_build`` serves on the
card.

``shard_build`` / ``shard_knn`` map the same architecture onto a
``torch.distributed`` process group with one rank per shard (``mesh.py``;
the JAX package runs them under ``shard_map`` on a device mesh).  A global
sample is all-gathered to compute the top-level median splits (central
Step 1), points travel to their owner shard with a fixed-capacity
``all_to_all`` (the network distribution step), and each shard builds its
local grid index (``grid_index.build``).  k-NN is the two-round protocol:
local candidates, then a global top-k over the gathered candidates
(``gather_topk_merge``).  ``shard_build_tables`` flattens the shards into
``NodeTable``s for the sharded device engine.

The port of the JAX package's ``repro/core/distributed.py``.  Departures:
each function takes the rank's own slice and returns the rank's own share
(``stack_shards`` assembles the reference's layout with a leading shard
dimension); ``shard_build`` pads the received buffer with empty slots to
a multiple of the leaf count where the reference requires one;
``shard_knn`` also returns a global certificate; and the merge ranks live
candidates before padding, which it reports as id -1 at f32 max.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops
from ..kernels.ref import F32_MAX, top_k
from . import grid_index
from .fmbi import Index, Node, bulk_load
from .grid_index import GridIndex
from .mesh import all_gather, all_reduce_sum, all_to_all
from .nodetable import NodeTable
from .pagestore import IOStats, PageStore, branch_capacity, leaf_capacity
from .queries_torch import _PAD_KEY, _dist_key, resolve_device
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


# --------------------------------------------------------------------------
# process-group build and queries (Section 5 on torch.distributed)
# --------------------------------------------------------------------------
def _topk_merge(all_d2, all_rows, k_out: int):
    """Merge gathered per-shard top-k lists (m, Q, kk) to the ``k_out``
    global best per query: ``(d2, rows, source)``, ``source`` being each
    result's shard.

    Candidates rank by order-preserving int32 keys: live rows by distance
    (``+inf`` included), then padding (row -1, reported at f32 max), then
    NaN; among equal keys the lower gathered position comes first, as
    ``jax.lax.top_k`` orders them.  Ranking raw distances would put one
    shard's padding (f32 max) before another shard's live row at ``+inf``
    (ROADMAP C.1)."""
    m, q, kk = all_d2.shape
    flat_d2 = all_d2.permute(1, 0, 2).reshape(q, m * kk)
    flat_rw = all_rows.permute(1, 0, 2).reshape(q, m * kk)
    key = torch.where(flat_rw >= 0, _dist_key(flat_d2), _PAD_KEY)
    _, topi = top_k(-key, k_out)
    rows = flat_rw.gather(1, topi)
    d2 = torch.where(rows >= 0, flat_d2.gather(1, topi), F32_MAX)
    return d2, rows, (topi // kk).to(torch.int32)


def gather_topk_merge(d2, rows, group, k_out: int):
    """Global round of the two-round k-NN protocol: all-gather every
    rank's per-query (distance, row) top-k and merge to the ``k_out``
    global best.  Returns ``(d2, rows, source)`` on every rank (see
    :func:`_topk_merge`).  Shared by ``shard_knn`` and
    ``distributed_torch.knn_batch_shard_map``."""
    shape = (group.size, *d2.shape)
    all_d2 = all_gather(group, d2.contiguous()).view(shape)
    all_rows = all_gather(group, rows.contiguous()).view(shape)
    return _topk_merge(all_d2, all_rows, k_out)


def _median_splits(sample: torch.Tensor, levels: int):
    """Replicated median splits over a gathered sample (central Step 1):
    per level and group, the dimension of largest spread (the first among
    equal ones) and the key of the last left point after a stable sort.
    This is ``grid_index.build``'s split loop, so its split tables are the
    result (``+inf`` beyond the groups a level uses)."""
    idx = grid_index.build(sample, levels, device=sample.device)
    return idx.split_dim, idx.split_val


def _route_tables(points: torch.Tensor, sdim: torch.Tensor, sval: torch.Tensor):
    """Owner shard of each point down the global split tables: the
    ``partition_assign`` kernel."""
    return ops.partition_assign(points, sdim, sval, levels=sdim.shape[0])


@dataclasses.dataclass
class LocalShard:
    """One rank's share of :func:`shard_build`: its grid index over the
    points it owns (global row ids, -1 for empty slots), how many points it
    received (``n_mine``), how many of its own input rows it dropped at the
    capacity (``n_dropped``), and the global split tables."""

    index: GridIndex
    n_mine: int
    n_dropped: int
    gsplit_dim: torch.Tensor
    gsplit_val: torch.Tensor

    def arrays(self) -> tuple:
        """This shard's slice of the reference's 9-tuple as host NumPy:
        ``(points_sorted, row_ids, split_dim, split_val, leaf_lo, leaf_hi,
        n_mine, gsplit_dim, gsplit_val)``."""
        ix = self.index
        cols = (ix.points_sorted, ix.row_ids, ix.split_dim, ix.split_val,
                ix.leaf_lo, ix.leaf_hi)
        return (*(t.cpu().numpy() for t in cols),
                np.array([self.n_mine], dtype=np.int32),
                self.gsplit_dim.cpu().numpy(), self.gsplit_val.cpu().numpy())


def stack_shards(per_shard) -> tuple:
    """The reference's ``shard_build`` output from every shard's
    :meth:`LocalShard.arrays`, in rank order: nine arrays, each with a
    leading shard dimension."""
    return tuple(np.stack(col) for col in zip(*per_shard))


def shard_build(pts_local, levels_local: int, group, *,
                sample_per_shard: int = 256) -> LocalShard:
    """Distributed FMBI build, run by every rank of ``group`` on its row
    slice of the dataset (rank r holds rows ``r*per .. (r+1)*per``, every
    rank the same ``per``), on the group's device.

    A strided sample of ``sample_per_shard`` rows per rank is all-gathered
    and median-split into ``log2(m)`` global levels; every point is routed
    to its owner shard (``partition_assign``) and sent there by an
    ``all_to_all`` of ``cap = max(2*per//m, per//m + sample_per_shard, 8)``
    slots per (source, owner) pair, in stable owner order.  Points past a
    pair's capacity are dropped, as the reference drops them.  The
    received ``m*cap`` slots (f32 max and row -1 where empty; padded with
    such slots to a multiple of ``2^levels_local``, which the reference
    requires instead) become the rank's grid index.  ``group.seconds``
    gains the spans ``sample_gather``, ``route``, ``all_to_all`` and
    ``build``."""
    m = group.size
    levels_global = m.bit_length() - 1
    if 1 << levels_global != m:
        raise ValueError("shard count must be a power of 2")
    dev = group.device
    pts = torch.as_tensor(pts_local, dtype=torch.float32).to(dev).contiguous()
    per, d = pts.shape
    if per * m >= 2**31:
        raise ValueError(f"{per * m} points exceed the int32 row ids")
    cap = max(2 * per // m, per // m + sample_per_shard, 8)
    ids = group.rank * per + torch.arange(per, dtype=torch.int32, device=dev)
    with group.timed("sample_gather"):
        stride = max(per // sample_per_shard, 1)
        sample = all_gather(group, pts[::stride][:sample_per_shard].contiguous())
    with group.timed("route"):
        if levels_global:
            gs_dim, gs_val = _median_splits(sample, levels_global)
            owner = _route_tables(pts, gs_dim, gs_val)
        else:
            gs_dim = torch.zeros((1, 1), dtype=torch.int32, device=dev)
            gs_val = torch.zeros((1, 1), dtype=torch.float32, device=dev)
            owner = torch.zeros(per, dtype=torch.int32, device=dev)
    with group.timed("all_to_all"):
        owner_sorted, order = torch.sort(owner, stable=True)
        first = torch.searchsorted(
            owner_sorted, torch.arange(m, dtype=torch.int32, device=dev))
        owner_sorted = owner_sorted.long()
        pos = torch.arange(per, device=dev) - first[owner_sorted]
        keep = pos < cap
        slot = owner_sorted[keep] * cap + pos[keep]
        send = torch.full((m * cap, d), F32_MAX, dtype=torch.float32, device=dev)
        send_ids = torch.full((m * cap,), -1, dtype=torch.int32, device=dev)
        send[slot] = pts[order[keep]]
        send_ids[slot] = ids[order[keep]]
        if m > 1:
            recv, recv_ids = all_to_all(group, send), all_to_all(group, send_ids)
        else:
            recv, recv_ids = send, send_ids
    n_mine = int((recv_ids >= 0).sum())
    unit = 1 << levels_local
    extra = -recv.shape[0] % unit
    if extra:
        recv = torch.cat([recv, recv.new_full((extra, d), F32_MAX)])
        recv_ids = torch.cat([recv_ids, recv_ids.new_full((extra,), -1)])
    with group.timed("build"):
        local = grid_index.build(recv, levels_local, recv_ids, device=dev)
    return LocalShard(local, n_mine, int((~keep).sum()), gs_dim, gs_val)


def unpack_local_index(shard_out, shard: int, levels_local: int, *,
                       device=None) -> GridIndex:
    """Shard ``shard``'s :class:`GridIndex` from :func:`stack_shards`
    output, on ``device`` (``cuda`` unless named; raises without a card)."""
    ps, ri, sd, sv, lo, hi, *_ = shard_out
    n_leaves = 1 << levels_local
    arrays = {name: torch.from_numpy(np.ascontiguousarray(a[shard]))
              for name, a in zip(GridIndex.ARRAYS, (ps, ri, sd, sv, lo, hi))}
    host = GridIndex(**arrays, levels=levels_local,
                     leaf_size=ps[shard].shape[0] // n_leaves)
    return host.to(resolve_device(device))


def table_from_jax_index(gidx: GridIndex) -> NodeTable:
    """Flatten a :class:`GridIndex` (the port's ``JaxIndex``; the name is
    the JAX package's) leaf grid into a one-level :class:`NodeTable`.

    Empty (all-padding) leaves are dropped and leaf MBBs are recomputed
    tight over the valid points (the grid's leaf boxes include the padding
    sentinels).  ``perm`` takes the grid's ``row_ids`` verbatim, so a
    ``shard_build`` shard, which carries global dataset ids through the
    all_to_all, flattens into a table that addresses the global dataset,
    ready for the sharded device engine.  Host NumPy."""
    pts = gidx.points_sorted.cpu().numpy().astype(np.float64)
    ids = gidx.row_ids.cpu().numpy()
    n_l, s = gidx.n_leaves, gidx.leaf_size
    d = pts.shape[1]
    grid = pts.reshape(n_l, s, d)
    ids2 = ids.reshape(n_l, s)
    valid = ids2 >= 0
    live = np.flatnonzero(valid.any(axis=1))
    if len(live) == 0:
        raise ValueError("grid holds no valid points")
    lo = np.where(valid[..., None], grid, np.inf).min(axis=1)
    hi = np.where(valid[..., None], grid, -np.inf).max(axis=1)
    leaves = [
        Node(
            mbb=np.stack([lo[leaf], hi[leaf]]),
            page_id=1 + j,
            point_idx=ids2[leaf][valid[leaf]].astype(np.int64),
        )
        for j, leaf in enumerate(live)
    ]
    if len(leaves) == 1:
        root = leaves[0]
        root.page_id = 0
    else:
        root = Node(
            mbb=np.stack([lo[live].min(axis=0), hi[live].max(axis=0)]),
            page_id=0,
            children=leaves,
        )
    return NodeTable.from_tree(root, d, n_points_hint=int(valid.sum()))


def shard_build_tables(shard_out, levels_local: int) -> list[NodeTable]:
    """Per-shard :class:`NodeTable`s from :func:`stack_shards` output: the
    bridge that lands the collective build on the representation of the
    host m-server simulation and the sharded device engine
    (``ShardedDeviceTable.from_tables``).  Host NumPy."""
    n_shards = np.asarray(shard_out[0]).shape[0]
    return [
        table_from_jax_index(
            unpack_local_index(shard_out, s, levels_local, device="cpu"))
        for s in range(n_shards)
    ]


def shard_knn(local: GridIndex, queries, k: int, group, *,
              n_candidate_leaves: int = 8):
    """Two-round distributed k-NN (paper Section 5 / SpatialHadoop), run by
    every rank on its own shard's index: local candidates
    (``grid_index.knn``), then a global top-k over the gathered (distance,
    row) candidates.  Returns ``(d2, rows, source, exact)``, the same on
    every rank; ``exact`` holds where every shard's local answer was
    certified (the reference returns the first three only)."""
    q = torch.as_tensor(queries, dtype=torch.float32).to(local.device)
    rows, d2, exact = grid_index.knn(local, q, k, n_candidate_leaves=n_candidate_leaves)
    top_d2, sel_rows, sel_src = gather_topk_merge(d2, rows, group, k)
    uncertified = all_reduce_sum(group, (~exact).to(torch.int32))
    return top_d2, sel_rows, sel_src, uncertified == 0
