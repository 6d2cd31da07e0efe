"""Device query engine of the PyTorch port: window and k-NN batches.

The port of the JAX package's device engine (``repro/core/queries_jax.py``):
the fused engine (``_window_batch_fused`` and ``_knn_batch_fused`` with the
functions under them) and the first-generation one (``fused=False``).  A
``NodeTable`` is exported once into fixed-shape tensors on the card
(:class:`DeviceTable`); each query batch then runs on the device, and
hand-written CUDA kernels carry the geometry (``kernels/ops.py``).  The
fused engine is the default; ``fused=False``, or ``REPRO_FUSED=0`` in the
environment, selects the first-generation one.

Fused engine (a few scalar syncs per batch):

  * **Window batch.**  A level-synchronous frontier descent tests each
    level block's boxes against the whole batch (``box_hits_tiled``, one
    launch per level block; against the outward-rounded bf16 bounds of a
    compressed export), and survival propagates down through each row's
    parent position.  The (Q, L) leaf hit mask is compacted on the device
    into (window, leaf) pairs by a cumulative sum probed with
    ``searchsorted``; pairs stream in power-of-two buckets of at most
    ``PAIR_CHUNK`` through ``pair_window_ids`` (one launch per chunk),
    which re-checks each leaf box in exact f32 and tests containment.
    The qualifying ids are compacted on the device too.  Host syncs: one
    for the pair count, one per chunk for its id total, and the final
    transfer of the packed ids.
  * **k-NN batch.**  Each query ranks the leaves by box mindist
    (``leaf_mindist_tiled``; compressed bounds where exported, which only
    lowers a mindist), scans its C closest through ``pair_dist2``, merges
    top-k in two levels (within each leaf, then across the C winners; a
    live slot ranks before padding even where its distance overflows to
    ``+inf``) and certifies the result against the mindist of the closest
    unscanned leaf.  Queries whose certificate fails rerun with a doubled
    budget, gathered and scattered back on the device; the host syncs one
    scalar (the failure count) per round.

First-generation engine (packs on the host, reads only the f32 bounds):

  * **Window batch.**  ``frontier_leaf_hits`` (``box_hits_tiled`` per
    level block) gives the (Q, L + U) hit mask, which moves to the host;
    ``np.nonzero`` lists the (window, leaf) pairs, which stream in
    power-of-two buckets of at most ``PAIR_CHUNK`` through
    ``_pair_collect`` (the leaf blocks gathered on the device and tested
    by ``window_mask_gathered``); each (P, S) mask moves to the host,
    where the ids are gathered from ``DeviceTable.host_ids``.
  * **k-NN batch.**  ``_knn_core`` ranks the leaves by f32 box mindist
    (``leaf_mindist_tiled``), gathers the C closest leaf blocks and scans
    them with ``gathered_dist2``, then merges and certifies as the fused
    round does.  The host loop reruns the uncertified queries with a
    doubled budget, moving each round's results to the host.

The device of the tensors picks the arithmetic: on the card every kernel
launches (or raises), on the CPU the same function runs as its plain
version.  Entry points export to ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise.

Parity contract (as the JAX engine's): windows return exactly the NumPy
engine's id sets for float32-representable inputs; k-NN returns the exact
k nearest under float32 distance arithmetic, with ids that may differ only
among exact ties.  Result order within a window set is unspecified.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from ..kernels import ops as kops
from .nodetable import NodeTable, compress_boxes_bf16

BIG = float(np.finfo(np.float32).max)

# one scan covers at most this many (window, leaf) pairs; a bigger
# candidate set streams in chunks so memory stays bounded
PAIR_CHUNK = 16384


def _pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def _fused_default() -> bool:
    """Resolve the ``fused`` flag: the ``REPRO_FUSED`` env var (1/0) wins
    (0 pins the first-generation host-packing path for A/B runs), else the
    fused engine is the default."""
    env = os.environ.get("REPRO_FUSED")
    if env is not None and env != "":
        return env not in ("0", "false", "False")
    return True


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    asked for and absent (there is no silent move to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the engine runs on the card; pass device='cpu' "
            "to run the plain versions on the host"
        )
    return dev


@dataclasses.dataclass
class UploadStats:
    """Host -> device upload counters (per instance: each
    ``DeviceQueryServer``, and each export given no sink, owns its own).
    Supports dict-style reads for the counter names."""

    full_exports: int = 0          # DeviceTable.from_table calls
    delta_refreshes: int = 0       # DeviceTable.apply_delta calls
    uploaded_leaf_blocks: int = 0  # leaf blocks shipped host -> device
    uploaded_points: int = 0       # live points inside those blocks

    def __getitem__(self, key: str) -> int:
        if key not in self.__dataclass_fields__:
            raise KeyError(key)
        return getattr(self, key)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def reset(self) -> dict:
        """Zero the counters; returns the pre-reset values."""
        old = self.as_dict()
        for k in self.__dataclass_fields__:
            setattr(self, k, 0)
        return old

    def record_export(self, n_blocks: int, n_points: int) -> None:
        self.full_exports += 1
        self.uploaded_leaf_blocks += int(n_blocks)
        self.uploaded_points += int(n_points)

    def record_delta(self, n_blocks: int, n_points: int) -> None:
        self.delta_refreshes += 1
        self.uploaded_leaf_blocks += int(n_blocks)
        self.uploaded_points += int(n_points)


def _bf16(u16: np.ndarray, device) -> torch.Tensor:
    """Upload outward-rounded bf16 bit patterns (``np.uint16``) as a
    ``torch.bfloat16`` tensor: a reinterpretation, no rounding."""
    t = torch.from_numpy(np.ascontiguousarray(u16).view(np.int16))
    return t.view(torch.bfloat16).to(device)


def _upload(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _upload_levels(blocks: list, n_slots: int, compressed: bool, device):
    """Host level blocks (``NodeTable.level_blocks``) -> the per-depth
    ``levels`` and ``terminals`` tuples of a ``DeviceTable``, and with
    ``compressed`` the bf16 ``levels_c`` (else None).  A row is terminal
    (a leaf or cold row) when its slot is below ``n_slots`` = leaves +
    cold rows; branches carry the sentinel slot ``n_slots``.  Shared by
    the full export and the delta refresh, whose slot numbering moves
    with every graft."""
    levels, terminals, levels_c = [], [], []
    for lv in blocks:
        slot = lv["slot"].astype(np.int64)
        term = np.flatnonzero(slot < n_slots)
        levels.append((_upload(lv["lo"], device), _upload(lv["hi"], device),
                       _upload(lv["parent"].astype(np.int64), device)))
        terminals.append((_upload(term, device), _upload(slot[term], device)))
        if compressed:
            lo_c, hi_c = ((lv["lo_c"], lv["hi_c"]) if "lo_c" in lv
                          else compress_boxes_bf16(lv["lo"], lv["hi"]))
            levels_c.append((_bf16(lo_c, device), _bf16(hi_c, device)))
    return tuple(levels), tuple(terminals), tuple(levels_c) if compressed else None


@dataclasses.dataclass
class DeviceTable:
    """Fixed-shape device export of a ``NodeTable``.

    ``levels`` holds one block per tree depth: ``(lo, hi, parent)`` with
    the rows' f32 bounds and each row's position within the previous
    level's block (see ``NodeTable.device_layout``).  ``terminals`` holds,
    per level, the positions of the leaf and cold rows and their frontier
    slots: every such row owns a distinct slot, so the frontier writes its
    hits with a plain assignment (branch rows, which share the JAX engine's
    sentinel slot, are never written).  A partial export
    carries the unrefined rows' boxes in ``cold_lo``/``cold_hi``; a
    compressed one carries outward-rounded bf16 copies of every bound
    column (``leaf_lo_c``/``leaf_hi_c``, ``levels_c``).  The host maps
    ``leaf_rows``/``cold_rows`` name the table row behind each slot: what
    :meth:`apply_delta` extends after the host grafts new subtrees and
    :meth:`remap_rows` rebases after ``NodeTable.compact``.
    """

    leaf_pts: torch.Tensor     # (L, S, d) f32 leaf-blocked points, pad = f32 max
    leaf_ids: torch.Tensor     # (L, S) int32 dataset rows, pad = -1
    leaf_counts: torch.Tensor  # (L,) int32 live slots per leaf block
    leaf_lo: torch.Tensor      # (L, d) f32
    leaf_hi: torch.Tensor      # (L, d) f32
    levels: tuple              # per depth: (lo, hi, parent int64)
    terminals: tuple           # per depth: (positions int64, slots int64)
    cold_lo: torch.Tensor      # (U, d) f32 unrefined-row boxes
    cold_hi: torch.Tensor
    leaf_lo_c: torch.Tensor = None  # (L, d) bf16 (compressed export)
    leaf_hi_c: torch.Tensor = None
    levels_c: tuple = None          # per depth: (lo_c, hi_c) bf16
    n_points: int = 0
    upload_stats: UploadStats = None
    leaf_rows: np.ndarray = None    # (L,) table row behind each leaf slot
    cold_rows: np.ndarray = None    # (U,) table row behind each cold slot

    @property
    def compressed(self) -> bool:
        return self.leaf_lo_c is not None

    @property
    def device(self) -> torch.device:
        return self.leaf_pts.device

    @property
    def n_leaves(self) -> int:
        return self.leaf_pts.shape[0]

    @property
    def n_cold(self) -> int:
        return self.cold_lo.shape[0]

    @property
    def leaf_size(self) -> int:
        return self.leaf_pts.shape[1]

    @property
    def dim(self) -> int:
        return self.leaf_pts.shape[2]

    @functools.cached_property
    def host_ids(self) -> np.ndarray:
        """Host copy of ``leaf_ids``: the first-generation window path
        packs its ids on the host.  The export and the delta refresh seed
        it with the blocks they uploaded; otherwise it is copied from the
        device at first use and kept."""
        return self.leaf_ids.cpu().numpy()

    def live_points(self) -> int:
        """Live point count (the sum of the leaf fills)."""
        return self.n_points

    @classmethod
    def from_table(cls, table: NodeTable, points: np.ndarray, *,
                   partial: bool = False, compressed: bool = False,
                   stats: UploadStats | None = None,
                   device=None) -> "DeviceTable":
        """Export ``table`` over ``points`` (a full upload) to ``device``
        (``cuda`` unless given).

        ``n_points`` is the table's live point count (the sum of its leaf
        fills); a partial export counts only the refined points.
        ``compressed=True`` also ships outward-rounded bf16 bound columns,
        which the traversal and the k-NN ranking read; the exact f32
        columns stay for the window re-check, so results are unchanged.
        """
        dev = resolve_device(device)
        lay = table.device_layout(np.asarray(points), partial=partial,
                                  compressed=compressed)
        n_leaves = lay["leaf_pts"].shape[0]
        levels, terminals, levels_c = _upload_levels(
            lay["levels"], n_leaves + len(lay["cold_rows"]), compressed, dev)
        n_points = int(lay["leaf_counts"].sum())
        sink = stats if stats is not None else UploadStats()
        sink.record_export(n_leaves, n_points)
        out = cls(
            leaf_pts=_upload(lay["leaf_pts"], dev),
            leaf_ids=_upload(lay["leaf_ids"], dev),
            leaf_counts=_upload(lay["leaf_counts"], dev),
            leaf_lo=_upload(lay["leaf_lo"], dev),
            leaf_hi=_upload(lay["leaf_hi"], dev),
            levels=levels,
            terminals=terminals,
            cold_lo=_upload(lay["cold_lo"], dev),
            cold_hi=_upload(lay["cold_hi"], dev),
            leaf_lo_c=_bf16(lay["leaf_lo_c"], dev) if compressed else None,
            leaf_hi_c=_bf16(lay["leaf_hi_c"], dev) if compressed else None,
            levels_c=levels_c,
            n_points=n_points,
            upload_stats=sink,
            leaf_rows=lay["leaf_rows"],
            cold_rows=lay["cold_rows"],
        )
        out.host_ids = lay["leaf_ids"]
        return out

    @classmethod
    def from_index(cls, index, *, compressed: bool = False,
                   stats: UploadStats | None = None,
                   device=None) -> "DeviceTable":
        """From a built ``core.fmbi.Index`` (table + dataset)."""
        return cls.from_table(index.table, index.points, compressed=compressed,
                              stats=stats, device=device)

    def apply_delta(self, table: NodeTable, points: np.ndarray) -> "DeviceTable":
        """Incremental refresh after host-side grafts: returns a *new*
        ``DeviceTable`` (double-buffered: the caller keeps serving this
        one until it swaps) in which only the freshly grafted leaf blocks
        are uploaded from the host.

        Grafting never changes an existing refined leaf (it refines an
        unrefined row in place and appends new rows), so every leaf slot
        this export holds stays valid verbatim: the point and id blocks
        are extended on the device (old blocks are reused, padded there
        to a wider slot count, f32 max and id -1, if a new leaf is fuller
        than any before) and only the new leaves' blocks cross from the
        host.  The O(n_nodes) traversal metadata (level blocks, leaf and
        cold boxes, fill counts, the terminal slots, and on a compressed
        export its re-rounded bf16 bounds) is rebuilt on the host and
        uploaded whole: cold slots are renumbered with every graft.
        """
        if self.leaf_rows is None:
            raise ValueError(
                "delta refresh needs the host scaffolding (leaf_rows); "
                "re-export with DeviceTable.from_table"
            )
        dev = self.device
        d = self.dim
        old_rows = self.leaf_rows
        known = np.zeros(table.n_nodes, dtype=bool)
        known[old_rows] = True
        rows_now = table.leaf_rows()
        new_rows = rows_now[~known[rows_now]]
        leaf_rows = np.concatenate([old_rows, new_rows])
        counts_new = table.leaf_count[new_rows]
        s_old = self.leaf_size
        s = max(s_old, int(counts_new.max()) if len(counts_new) else 1)
        lp, li = self.leaf_pts, self.leaf_ids
        ids_host = self.host_ids
        if s > s_old:  # widen the existing blocks on the device
            l_old = self.n_leaves
            lp = torch.cat([lp, lp.new_full((l_old, s - s_old, d), BIG)], dim=1)
            li = torch.cat([li, li.new_full((l_old, s - s_old), -1)], dim=1)
            ids_host = np.pad(ids_host, ((0, 0), (0, s - s_old)),
                              constant_values=-1)
        if len(new_rows):
            nb_pts, nb_ids = table.pack_leaf_blocks(
                new_rows, np.asarray(points), s, np.float32)
            lp = torch.cat([lp, _upload(nb_pts, dev)])
            li = torch.cat([li, _upload(nb_ids, dev)])
            ids_host = np.concatenate([ids_host, nb_ids])
        cold = np.flatnonzero(table.unrefined)
        blocks = table.level_blocks(table.slot_map(leaf_rows, cold), np.float32)
        levels, terminals, levels_c = _upload_levels(
            blocks, len(leaf_rows) + len(cold), self.compressed, dev)
        counts = table.leaf_count[leaf_rows].astype(np.int32)
        new_lo = table.mbb_lo[leaf_rows].astype(np.float32)
        new_hi = table.mbb_hi[leaf_rows].astype(np.float32)
        if self.compressed:
            lo_c, hi_c = compress_boxes_bf16(new_lo, new_hi)
            leaf_lo_c, leaf_hi_c = _bf16(lo_c, dev), _bf16(hi_c, dev)
        else:
            leaf_lo_c = leaf_hi_c = None
        self.upload_stats.record_delta(len(new_rows), int(counts_new.sum()))
        out = DeviceTable(
            leaf_pts=lp,
            leaf_ids=li,
            leaf_counts=_upload(counts, dev),
            leaf_lo=_upload(new_lo, dev),
            leaf_hi=_upload(new_hi, dev),
            levels=levels,
            terminals=terminals,
            cold_lo=_upload(table.mbb_lo[cold].astype(np.float32), dev),
            cold_hi=_upload(table.mbb_hi[cold].astype(np.float32), dev),
            leaf_lo_c=leaf_lo_c,
            leaf_hi_c=leaf_hi_c,
            levels_c=levels_c,
            n_points=int(counts.sum()),
            upload_stats=self.upload_stats,
            leaf_rows=leaf_rows,
            cold_rows=cold,
        )
        out.host_ids = ids_host
        return out

    def remap_rows(self, remap: np.ndarray) -> None:
        """Rebase the host maps after ``NodeTable.compact`` (renumbering
        rows changes no leaf content, so the device tensors stay)."""
        if self.leaf_rows is not None:
            self.leaf_rows = remap[self.leaf_rows]
        if self.cold_rows is not None:
            self.cold_rows = remap[self.cold_rows]


# --------------------------------------------------------------------------
# window batch
# --------------------------------------------------------------------------
def frontier_leaf_hits(dev: DeviceTable, qlo: torch.Tensor,
                       qhi: torch.Tensor, *, compressed: bool = False):
    """(Q, L + U) bool mask of the leaf slots, and on a partial export the
    cold (unrefined) slots, whose box intersects each window.

    One ``box_hits_tiled`` launch per level block, against the f32 bounds,
    or with ``compressed=True`` against the bf16 bounds of a compressed
    export (a superset of the f32 hits, which the fused pair scan
    re-checks).  A row survives when its box hits and its parent
    survived."""
    n_slots = dev.n_leaves + dev.n_cold
    slot_hit = torch.zeros((n_slots, qlo.shape[0]), dtype=torch.bool,
                           device=qlo.device)
    prev = None
    for i, (lo, hi, parent) in enumerate(dev.levels):
        if compressed:
            lo, hi = dev.levels_c[i]
        hit = kops.box_hits_tiled(lo, hi, qlo, qhi) > 0   # (n_level, Q)
        if prev is not None:
            hit &= prev[parent]
        pos, slot = dev.terminals[i]
        slot_hit[slot] = hit[pos]   # distinct slots: a plain assignment
        prev = hit
    return slot_hit.t().contiguous()


def _frontier_count(dev: DeviceTable, qlo: torch.Tensor, qhi: torch.Tensor):
    """The fused frontier: the hit mask over the export's cheapest bounds
    (bf16 where compressed), plus the number of (window, leaf) pairs as a
    device scalar."""
    hits = frontier_leaf_hits(dev, qlo, qhi, compressed=dev.compressed)
    return hits, hits[:, : dev.n_leaves].sum()


def _compact_idx(csum: torch.Tensor, first: int, count: int):
    """Positions of the set bits ``first .. first + count - 1`` (1-based
    ranks) of a flat 0/1 mask, given the mask's inclusive cumulative sum;
    ranks past the total come back clamped to the last position."""
    ranks = torch.arange(first, first + count, dtype=csum.dtype,
                         device=csum.device)
    pos = torch.searchsorted(csum, ranks)
    return pos.clamp_(max=csum.shape[0] - 1), ranks


def _cumsum(mask: torch.Tensor) -> torch.Tensor:
    dtype = torch.int32 if mask.numel() < 2**31 else torch.int64
    return torch.cumsum(mask, 0, dtype=dtype)


def _fused_pack_scan(dev: DeviceTable, qlo, qhi, csum, a: int, pc: int,
                     n_pairs: int, per_query: torch.Tensor):
    """Pack pairs ``a .. a + pc`` of the hit mask (row-major, so they stay
    grouped by window), scan them with ``pair_window_ids`` and add each
    pair's count to its window.  Returns the (pc, S) ids-or-minus-one
    matrix and the chunk's id total (a device scalar)."""
    pos, ranks = _compact_idx(csum, a + 1, pc)
    pair_valid = (ranks <= n_pairs).to(torch.int32)
    q_idx = pos // dev.n_leaves
    leaf_idx = (pos % dev.n_leaves).to(torch.int32)
    ids_or, pair_counts = kops.pair_window_ids(
        qlo, qhi, dev.leaf_lo, dev.leaf_hi, dev.leaf_pts, dev.leaf_ids,
        dev.leaf_counts, q_idx.to(torch.int32), leaf_idx, pair_valid,
    )
    per_query.index_add_(0, q_idx, pair_counts.to(per_query.dtype))
    return ids_or, pair_counts.sum()


def _fused_id_pack(ids_or: torch.Tensor, total: int) -> torch.Tensor:
    """The ``total`` non-negative entries of the (P, S) id matrix, in pair
    order, compacted on the device through a power-of-two bucket."""
    flat = ids_or.reshape(-1)
    r = _pow2(total)
    pos, ranks = _compact_idx(_cumsum(flat >= 0), 1, r)
    packed = torch.where(ranks <= total, flat[pos], -1)
    return packed[:total]


def _pair_collect(dev: DeviceTable, qlo, qhi, q_idx, leaf_idx, pair_valid):
    """Scan one bucket of (window, leaf) pairs: gather each pair's leaf
    block and test containment against its window.  Returns the (P, S)
    bool mask of the slots that are live and inside."""
    s = dev.leaf_size
    li = leaf_idx.long()
    qi = q_idx.long()
    pts = dev.leaf_pts[li]                     # (P, S, d)
    slot = torch.arange(s, dtype=torch.int32, device=pts.device)
    valid = (slot[None, :] < dev.leaf_counts[li][:, None]) & pair_valid[:, None]
    return kops.window_mask_gathered(qlo[qi], qhi[qi], pts,
                                     valid.to(torch.int32)) > 0


def _window_batch_unfused(dev: DeviceTable, qlo, qhi, return_cold: bool):
    """The first-generation window batch: the f32 frontier mask and each
    bucket's containment mask move to the host, which packs the ids."""
    q0 = qlo.shape[0]
    hits = frontier_leaf_hits(dev, qlo, qhi).cpu().numpy()
    inter, cold = hits[:, : dev.n_leaves], hits[:, dev.n_leaves:]
    q_idx, leaf_idx = np.nonzero(inter)   # row-major: grouped by window
    p0 = len(q_idx)
    if p0 == 0:
        empty = [np.zeros(0, dtype=np.int64) for _ in range(q0)]
        return (empty, cold) if return_cold else empty
    parts, pair_counts = [], []
    for a in range(0, p0, PAIR_CHUNK):
        b = min(a + PAIR_CHUNK, p0)
        p = _pow2(b - a)
        qi = np.zeros(p, dtype=np.int32)
        li = np.zeros(p, dtype=np.int32)
        qi[: b - a] = q_idx[a:b]
        li[: b - a] = leaf_idx[a:b]
        pv = np.arange(p) < (b - a)
        inside = _pair_collect(
            dev, qlo, qhi, *(torch.from_numpy(x).to(dev.device) for x in (qi, li, pv))
        ).cpu().numpy()
        ids = dev.host_ids[li]                # (P, S) host gather
        parts.append(ids[inside].astype(np.int64))
        pair_counts.append(inside.sum(axis=1)[: b - a])
    all_ids = np.concatenate(parts)
    per_pair = np.concatenate(pair_counts)
    per_query = np.bincount(q_idx, weights=per_pair, minlength=q0)
    res = np.split(all_ids, np.cumsum(per_query.astype(np.int64))[:-1])
    return (res, cold) if return_cold else res


def window_query_batch_torch(dev: DeviceTable, los, his, *,
                             fused: bool | None = None,
                             return_cold: bool = False):
    """Batched window query: per-window arrays of dataset row ids.

    Ids equal (as sets) those of the NumPy engine and the JAX engine for
    float32-representable inputs, on either engine: ``fused`` (default
    on; ``REPRO_FUSED=0`` pins the first-generation path) packs on the
    device, ``fused=False`` on the host.  On a partial export the ids
    cover only the refined leaves; ``return_cold=True`` also returns the
    (Q, U) mask of the unrefined rows each window reached (those windows
    must be answered on the host)."""
    if fused is None:
        fused = _fused_default()
    los = np.atleast_2d(np.asarray(los, dtype=np.float32))
    his = np.atleast_2d(np.asarray(his, dtype=np.float32))
    if los.shape != his.shape or los.ndim != 2 or los.shape[1] != dev.dim:
        raise ValueError(f"windows must be (Q, {dev.dim}) lo/hi pairs, got "
                         f"{los.shape} and {his.shape}")
    q0 = los.shape[0]
    qlo = torch.from_numpy(los).to(dev.device)
    qhi = torch.from_numpy(his).to(dev.device)
    if not fused:
        return _window_batch_unfused(dev, qlo, qhi, return_cold)
    hits, n_pairs = _frontier_count(dev, qlo, qhi)
    p0 = int(n_pairs)                                     # host sync
    cold = hits[:, dev.n_leaves:].cpu().numpy() if return_cold else None
    if p0 == 0:
        empty = [np.zeros(0, dtype=np.int64) for _ in range(q0)]
        return (empty, cold) if return_cold else empty
    csum = _cumsum(hits[:, : dev.n_leaves].reshape(-1))
    per_query = torch.zeros(q0, dtype=torch.int64, device=dev.device)
    parts = []
    for a in range(0, p0, PAIR_CHUNK):
        pc = _pow2(min(p0 - a, PAIR_CHUNK))
        ids_or, total = _fused_pack_scan(dev, qlo, qhi, csum, a, pc, p0,
                                         per_query)
        t = int(total)                                    # host sync
        if t:
            parts.append(_fused_id_pack(ids_or, t))
    all_ids = (torch.cat(parts).cpu().numpy().astype(np.int64)
               if parts else np.zeros(0, dtype=np.int64))
    res = np.split(all_ids, np.cumsum(per_query.cpu().numpy())[:-1])
    return (res, cold) if return_cold else res


# --------------------------------------------------------------------------
# k-NN batch
# --------------------------------------------------------------------------
# The merge ranks int32 keys, not distances.  A squared distance is
# non-negative or NaN, and its bit pattern with the sign cleared orders it:
# every finite value before +inf (0x7f800000).  A padding slot keys just
# above +inf, so a live point outranks padding whatever its distance (one
# whose distance overflows included), and a NaN keys above padding: the
# arithmetic that made it leaves it quiet, at least 0x7fc00000.
_SIGN_OFF = 0x7FFFFFFF
_PAD_KEY = 0x7F800001


def _dist_key(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) & _SIGN_OFF


def _live_slots(dev: DeviceTable, cand: torch.Tensor) -> torch.Tensor:
    """(Q, C, S) bool: slot ``j`` of candidate leaf ``cand[q, c]`` holds a
    point."""
    slot = torch.arange(dev.leaf_size, dtype=torch.int32, device=cand.device)
    return slot < dev.leaf_counts[cand][:, :, None]


def _knn_merge(dev: DeviceTable, mind, cand, d2, live, k: int):
    """Top-k of a round's (Q, C, S) candidate distances ``d2`` (``live``
    marks the slots that hold points) over the leaves ``cand`` ranked by
    ``mind`` (Q, L), and the certificate.

    Returns ``(ids, d2k, exact)`` of width ``min(k, C*S)``: live slots
    come first, by distance (``+inf`` included), then padding (id -1 at
    f32 max), then NaN distances.  ``exact`` holds where the k-th entry
    ranks no later than the mindist of the closest unscanned leaf, so
    padding never certifies against a leaf that holds points, and a NaN
    mindist certifies nothing.  ``mind`` is overwritten."""
    q, c, s = d2.shape
    kk = min(k, c * s)
    kl = min(kk, s)
    key = torch.where(live, _dist_key(d2), _PAD_KEY)
    # two-level merge: top-k within each leaf block, then across the C
    # block winners (same result set, smaller sort fronts)
    keyl, til = torch.topk(key, kl, dim=2, largest=False)       # (Q, C, kl)
    keyk, tim = torch.topk(keyl.reshape(q, c * kl), kk, dim=1, largest=False)
    ti = torch.gather(til.reshape(q, c * kl), 1, tim) + (tim // kl) * s
    leaf_sel = torch.gather(cand, 1, ti // s)
    ids = dev.leaf_ids[leaf_sel, ti % s]
    d2k = torch.gather(d2.reshape(q, c * s), 1, ti)   # padding holds f32 max
    if c >= dev.n_leaves:
        exact = torch.ones(q, dtype=torch.bool, device=d2.device)
    elif kk < k:  # fewer candidate slots than k: only a full scan certifies
        exact = torch.zeros(q, dtype=torch.bool, device=d2.device)
    else:
        unscanned = mind.scatter_(1, cand, float("inf")).min(dim=1).values
        exact = (keyk[:, -1] <= _dist_key(unscanned)) & (unscanned == unscanned)
    return ids, d2k, exact


def _knn_core(dev: DeviceTable, qs: torch.Tensor, k: int, c: int):
    """One first-generation k-NN round over each query's ``c`` closest
    leaves by f32 box mindist: the C leaf blocks are gathered into
    (Q, C*S, d) and scanned by ``gathered_dist2``.

    Returns ``(ids, d2k, exact)`` of width ``min(k, C*S)`` (see
    :func:`_knn_merge`).  It reads only ``leaf_pts``, ``leaf_ids``,
    ``leaf_counts`` and the f32 ``leaf_lo``/``leaf_hi`` of ``dev``."""
    q = qs.shape[0]
    n_l, s, d = dev.leaf_pts.shape
    c = min(c, n_l)
    mind = kops.leaf_mindist_tiled(qs, dev.leaf_lo, dev.leaf_hi)  # (Q, L)
    cand = torch.topk(mind, c, dim=1, largest=False).indices      # (Q, C)
    live = _live_slots(dev, cand)
    d2 = kops.gathered_dist2(
        qs, dev.leaf_pts[cand].reshape(q, c * s, d),
        live.reshape(q, c * s).to(torch.int32),
    ).reshape(q, c, s)
    return _knn_merge(dev, mind, cand, d2, live, k)


def _knn_core_fused(dev: DeviceTable, qs: torch.Tensor, k: int, c: int):
    """One fused k-NN round over each query's ``c`` closest leaves.

    Returns ``(ids, d2k, exact)`` padded to the budget-independent width
    ``min(k, L*S)`` (see :func:`_knn_merge`).  Ranking by the compressed
    bounds only lowers mindists, so the certificate stays conservative."""
    q = qs.shape[0]
    n_l, s, _ = dev.leaf_pts.shape
    c = min(c, n_l)
    if dev.compressed:
        blo, bhi = dev.leaf_lo_c, dev.leaf_hi_c
    else:
        blo, bhi = dev.leaf_lo, dev.leaf_hi
    mind = kops.leaf_mindist_tiled(qs, blo, bhi)                # (Q, L)
    cand = torch.topk(mind, c, dim=1, largest=False).indices    # (Q, C)
    q_rep = torch.arange(q, dtype=torch.int32, device=qs.device)
    d2 = kops.pair_dist2(
        qs, dev.leaf_pts, dev.leaf_counts, q_rep.repeat_interleave(c),
        cand.reshape(-1).to(torch.int32),
    ).reshape(q, c, s)
    ids, d2k, exact = _knn_merge(dev, mind, cand, d2, _live_slots(dev, cand), k)
    kk = d2k.shape[1]
    kf = min(k, n_l * s)
    if kf > kk:
        ids = torch.cat([ids, ids.new_full((q, kf - kk), -1)], dim=1)
        d2k = torch.cat([d2k, d2k.new_full((q, kf - kk), BIG)], dim=1)
    return ids, d2k, exact


def _knn_pending(qs: torch.Tensor, exact: torch.Tensor, p: int):
    """Pack the failed queries' indices into a ``p``-slot bucket and gather
    their coordinates on the device; slots past the failure count are
    marked invalid."""
    pos, ranks = _compact_idx(_cumsum(~exact), 1, p)
    n_fail = (~exact).sum()
    return pos, ranks <= n_fail, qs[pos]


def _knn_merge_round(bufs, b0: int, idx, valid, new) -> torch.Tensor:
    """Scatter a round's results over the result buffers, in place.

    The buffers carry one sentinel row past the batch: invalid bucket
    slots are routed there and dropped, so they never race a genuine
    update (scatter order among duplicate indices is undefined).  Returns
    the remaining failed-certificate count as a device scalar."""
    idx_w = torch.where(valid, idx, b0)
    for buf, val in zip(bufs, new):
        buf.index_copy_(0, idx_w, val)
    return (~bufs[2][:b0]).sum()


def _knn_budget(dev: DeviceTable, k: int, n_candidate_leaves: int | None):
    """The first round's candidate-leaf budget and its cap (powers of
    two)."""
    cap = _pow2(dev.n_leaves)
    if n_candidate_leaves is None:
        return min(_pow2(max(8, -(-2 * k) // dev.leaf_size)), cap), cap
    return min(_pow2(max(n_candidate_leaves, 1)), cap), cap


def _knn_batch(dev: DeviceTable, qs: np.ndarray, k: int,
               n_candidate_leaves: int | None, max_rounds: int | None):
    """Budget escalation on the device: returns the (b0, min(k, L*S)) id
    and distance buffers, the exact mask and whether the last round
    scanned every leaf."""
    b0 = qs.shape[0]
    c, cap = _knn_budget(dev, k, n_candidate_leaves)
    qt = torch.from_numpy(qs).to(dev.device)
    ids, d2k, exact = _knn_core_fused(dev, qt, k, c)
    # one sentinel row past the batch absorbs the padding slots of merges
    bufs = tuple(torch.cat([t, t[:1]]) for t in (ids, d2k, exact))
    full_scan = c >= dev.n_leaves
    n_fail = int((~exact).sum()) if not full_scan else 0  # host sync
    rounds = 0
    while n_fail and (max_rounds is None or rounds < max_rounds):
        c = min(c * 2, cap)
        idx, valid, qsel = _knn_pending(qt, bufs[2][:b0], _pow2(n_fail))
        nfail = _knn_merge_round(bufs, b0, idx, valid,
                                 _knn_core_fused(dev, qsel, k, c))
        full_scan = c >= dev.n_leaves
        n_fail = int(nfail) if not full_scan else 0       # host sync
        rounds += 1
    return bufs[0][:b0], bufs[1][:b0], bufs[2][:b0], full_scan


def _knn_batch_unfused(dev: DeviceTable, qs: np.ndarray, k: int,
                       n_candidate_leaves: int | None,
                       max_rounds: int | None):
    """The first-generation host loop: each round's results move to the
    host; the uncertified queries rerun with a doubled budget until every
    certificate holds, the whole leaf table is scanned, or ``max_rounds``
    flushes the rest as inexact.  Returns per-query id and distance
    arrays of length at most ``min(k, live points)`` and the exact
    mask."""
    q0 = qs.shape[0]
    c, cap = _knn_budget(dev, k, n_candidate_leaves)
    m = min(k, dev.live_points())
    results: list = [None] * q0
    dists: list = [None] * q0
    exact_mask = np.ones(q0, dtype=bool)
    pending = np.arange(q0)
    rounds = 0
    while len(pending):
        qt = torch.from_numpy(qs[pending]).to(dev.device)
        ids, d2k, exact = (t.cpu().numpy() for t in _knn_core(dev, qt, k, c))
        done = exact if c < dev.n_leaves else np.ones(len(pending), dtype=bool)
        flush = done
        if max_rounds is not None and rounds >= max_rounds:
            # budget cap: the still-failing queries get their best-effort
            # answers, marked inexact
            flush = np.ones(len(pending), dtype=bool)
        for j in np.flatnonzero(flush):
            results[pending[j]] = ids[j, :m].astype(np.int64)
            dists[pending[j]] = d2k[j, :m]
            exact_mask[pending[j]] = bool(done[j])
        pending = pending[~flush]
        c = min(c * 2, cap)
        rounds += 1
    return results, dists, exact_mask


def knn_query_batch_torch(dev: DeviceTable, qs, k: int, *,
                          fused: bool | None = None,
                          n_candidate_leaves: int | None = None,
                          return_dists: bool = False,
                          max_rounds: int | None = None,
                          return_exact: bool = False):
    """Batched k-NN: per-query ascending-distance row-id arrays of length
    ``min(k, live points)``.

    The candidate budget starts at a small power of two and doubles for
    the queries whose certificate failed until every certificate holds or
    the whole leaf table is scanned, so the ids are the exact k nearest
    (among exact ties the chosen ids may differ from another engine's).
    ``return_dists`` adds the float32 squared distances; ``max_rounds``
    caps the escalation rounds after the first, and ``return_exact`` adds
    the per-query mask of answers the certificate covers.  ``fused``
    (default on; ``REPRO_FUSED=0`` pins the first-generation path)
    escalates on the device, ``fused=False`` in a host loop; both return
    the same distances."""
    if fused is None:
        fused = _fused_default()
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if max_rounds is not None and max_rounds < 0:
        raise ValueError(f"max_rounds must be >= 0, got {max_rounds}")
    qs = np.atleast_2d(np.asarray(qs, dtype=np.float32))
    if qs.ndim != 2 or qs.shape[1] != dev.dim:
        raise ValueError(f"queries must be (Q, {dev.dim}), got {qs.shape}")
    q0 = qs.shape[0]
    if dev.n_leaves == 0:  # partial export with nothing refined yet
        ids = [np.zeros(0, dtype=np.int64) for _ in range(q0)]
        d2 = [np.zeros(0, dtype=np.float32) for _ in range(q0)]
        exact = np.ones(q0, dtype=bool)
    elif not fused:
        ids, d2, exact = _knn_batch_unfused(dev, qs, k, n_candidate_leaves,
                                            max_rounds)
    else:
        ids_b, d2_b, exact_b, full_scan = _knn_batch(
            dev, qs, k, n_candidate_leaves, max_rounds
        )
        m = min(k, dev.live_points())
        ids_h = ids_b[:, :m].cpu().numpy()
        ids = [ids_h[j].astype(np.int64) for j in range(q0)]
        d2 = list(d2_b[:, :m].cpu().numpy()) if return_dists else None
        if not return_exact:
            exact = None
        elif full_scan:  # whole leaf table scanned: vacuously exact
            exact = np.ones(q0, dtype=bool)
        else:
            exact = exact_b.cpu().numpy()
    out = (ids,)
    if return_dists:
        out += (d2,)
    if return_exact:
        out += (exact,)
    return out if len(out) > 1 else out[0]
