"""Simulated disk-page store with I/O accounting and an LRU buffer.

The paper evaluates every index inside a unified disk-based framework with
4 KiB pages and an LRU buffer sized as a fraction of the dataset.  This module
is the JAX-framework analogue of that substrate: pages are identified by
integer ids, reads/writes are counted, and an LRU buffer absorbs repeated
accesses exactly as the paper's buffer does.

Capacities follow the paper's arithmetic for 4 KiB pages:
  * leaf entry  = d float32 coords + 4-byte record id  -> C_L = 4096 // (4d+4)
  * branch entry = MBB (2 points, 2*d float32) + 4-byte pointer
                                                -> C_B = 4096 // (8d+4)
For d=2 this reproduces the paper's C_L = 341 and C_B = 204 verbatim.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

PAGE_SIZE = 4096
COORD_BYTES = 4
ID_BYTES = 4
POINTER_BYTES = 4


def leaf_capacity(d: int, page_size: int = PAGE_SIZE) -> int:
    """Points per leaf page (paper: C_L = 341 for d = 2)."""
    return page_size // (COORD_BYTES * d + ID_BYTES)


def branch_capacity(d: int, page_size: int = PAGE_SIZE) -> int:
    """Entries per branch page (paper: C_B = 204 for d = 2)."""
    return page_size // (2 * COORD_BYTES * d + POINTER_BYTES)


@dataclasses.dataclass
class IOStats:
    """Counters of simulated page I/O (the paper's cost metric)."""

    reads: int = 0
    writes: int = 0

    @property
    def total(self) -> int:
        return self.reads + self.writes

    def __add__(self, other: "IOStats") -> "IOStats":
        return IOStats(self.reads + other.reads, self.writes + other.writes)

    def snapshot(self) -> "IOStats":
        return IOStats(self.reads, self.writes)

    def delta(self, since: "IOStats") -> "IOStats":
        return IOStats(self.reads - since.reads, self.writes - since.writes)


class LRUBuffer:
    """LRU page buffer: a read of a resident page is free, as in the paper."""

    def __init__(self, capacity_pages: int):
        self.capacity = max(int(capacity_pages), 1)
        self._pages: OrderedDict[int, None] = OrderedDict()

    def __contains__(self, page_id: int) -> bool:
        return page_id in self._pages

    def __len__(self) -> int:
        return len(self._pages)

    def touch(self, page_id: int) -> bool:
        """Access a page; returns True on hit (no I/O)."""
        if page_id in self._pages:
            self._pages.move_to_end(page_id)
            return True
        self._pages[page_id] = None
        if len(self._pages) > self.capacity:
            self._pages.popitem(last=False)
        return False

    def evict(self, page_id: int) -> None:
        self._pages.pop(page_id, None)

    def clear(self) -> None:
        self._pages.clear()

    def load_run(self, page_ids) -> None:
        """Set the buffer to exactly ``page_ids`` (oldest first).

        Used by the run fast paths: after touching a run of >= capacity
        distinct pages, the buffer holds precisely the trailing ``capacity``
        pages of the run — whatever was resident before is evicted, so the
        state can be written directly instead of replayed touch by touch.
        """
        self._pages = OrderedDict.fromkeys(int(p) for p in page_ids)


class PageStore:
    """A page-granular simulated disk.

    Page *contents* are kept only as opaque python objects (the algorithms in
    ``core`` operate on in-memory numpy views of the data and charge I/O
    explicitly).  The store's job is strictly accounting: reads, writes, and
    buffered re-reads.
    """

    def __init__(self, buffer_pages: int, page_size: int = PAGE_SIZE):
        self.page_size = page_size
        self.stats = IOStats()
        self.buffer = LRUBuffer(buffer_pages)
        self._next_id = 0
        # Free-list of recycled page-id runs, kept sorted and coalesced as
        # ``[start, length]`` pairs.  Pages freed when a merged-away tier is
        # retired are handed back out by ``alloc`` (first fit) before the
        # high-water mark advances, so sustained ingest does not leak ids.
        self._free: list[list[int]] = []
        # Optional fault-injection hook, called as ``hook(op, n_pages)`` at
        # the *entry* of each accounted I/O op — before any counter or
        # buffer mutation, so an injected failure leaves the store's state
        # untouched and the op is safely retryable.
        self.fault_hook = None

    def _fault(self, op: str, n: int) -> None:
        if self.fault_hook is not None:
            self.fault_hook(op, n)

    # -- snapshot state ----------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-serializable state for snapshot barriers: the allocator,
        the I/O counters, and the exact LRU residency/order (recovery must
        reproduce buffered-vs-charged reads bit for bit)."""
        return {
            "page_size": self.page_size,
            "next_id": self._next_id,
            "reads": self.stats.reads,
            "writes": self.stats.writes,
            "buffer_capacity": self.buffer.capacity,
            "buffer_pages": [int(p) for p in self.buffer._pages],
            "free_runs": [[int(s), int(ln)] for s, ln in self._free],
        }

    def load_state(self, state: dict) -> None:
        self.page_size = int(state["page_size"])
        self._next_id = int(state["next_id"])
        self.stats = IOStats(int(state["reads"]), int(state["writes"]))
        self.buffer = LRUBuffer(int(state["buffer_capacity"]))
        self.buffer.load_run(state["buffer_pages"])
        self._free = [[int(s), int(ln)] for s, ln in state.get("free_runs", [])]

    # -- allocation -------------------------------------------------------
    def alloc(self, n: int = 1) -> int:
        """Reserve ``n`` consecutive page ids; returns the first id.

        Recycled runs (``free_range``) are reused first-fit before the
        high-water mark advances.
        """
        n = int(n)
        for i, (s, ln) in enumerate(self._free):
            if ln >= n:
                if ln == n:
                    del self._free[i]
                else:
                    self._free[i] = [s + n, ln - n]
                return s
        first = self._next_id
        self._next_id += n
        return first

    def free_range(self, first: int, n: int = 1) -> None:
        """Return ``n`` consecutive page ids starting at ``first`` to the
        allocator.  The freed pages are evicted from the LRU buffer: a
        recycled id must behave exactly like a fresh one for I/O accounting
        (its first read after re-allocation is a charged miss, never a free
        hit inherited from the retired owner)."""
        first, n = int(first), int(n)
        if n <= 0:
            return
        for pid in range(first, first + n):
            self.buffer.evict(pid)
        self._free.append([first, n])
        self._free.sort()
        merged = [self._free[0]]
        for s, ln in self._free[1:]:
            ps, pln = merged[-1]
            if s <= ps + pln:
                merged[-1][1] = max(pln, s + ln - ps)
            else:
                merged.append([s, ln])
        self._free = merged

    def free_pages(self, page_ids) -> None:
        """Free an arbitrary set of page ids (grouped into runs)."""
        ids = np.unique(np.asarray(list(page_ids), dtype=np.int64))
        if len(ids) == 0:
            return
        breaks = np.flatnonzero(np.diff(ids) != 1) + 1
        for run in np.split(ids, breaks):
            self.free_range(int(run[0]), len(run))

    @property
    def allocated_pages(self) -> int:
        """Allocator high-water mark (ids ever handed out)."""
        return self._next_id

    @property
    def free_page_count(self) -> int:
        return sum(ln for _, ln in self._free)

    @property
    def live_pages(self) -> int:
        """Pages currently owned by some index (high-water minus freed)."""
        return self._next_id - self.free_page_count

    def mark_allocated(self, n_pages: int) -> None:
        """Advance the allocator past ``n_pages`` already-existing pages —
        used when adopting an index whose pages were allocated elsewhere
        (snapshot load, merged per-server tables)."""
        self._next_id = max(self._next_id, int(n_pages))

    # -- accounted I/O ----------------------------------------------------
    def read(self, page_id: int, *, bypass_buffer: bool = False) -> None:
        self._fault("read", 1)
        self._read_accounted(page_id, bypass_buffer)

    def _read_accounted(self, page_id: int, bypass_buffer: bool = False) -> None:
        if bypass_buffer or not self.buffer.touch(page_id):
            self.stats.reads += 1

    def read_many(self, page_ids, *, bypass_buffer: bool = False) -> None:
        """Read a sequence of pages through the buffer.

        Fast path: for a run of *distinct* pages longer than the LRU
        capacity, a page at run position >= capacity cannot be resident when
        touched (the preceding ``capacity`` distinct touches have evicted
        it), so only the leading ``capacity`` pages go through the touch
        loop; the rest are bulk-charged as misses and the buffer is set to
        the trailing ``capacity`` pages.  Accounting is identical to the
        per-page loop — without the O(run) interpreter iteration.
        """
        ids = np.asarray(list(page_ids), dtype=np.int64)
        self._fault("read_many", len(ids))
        if bypass_buffer:
            self.stats.reads += len(ids)
            return
        cap = self.buffer.capacity
        n = len(ids)
        if n > cap and len(np.unique(ids)) == n:
            for pid in ids[:cap]:
                self._read_accounted(int(pid))
            self.stats.reads += n - cap
            self.buffer.load_run(ids[-cap:])
            return
        for pid in ids:
            self._read_accounted(int(pid))

    def read_run(self, n_pages: int) -> None:
        """A bulk sequential read of ``n_pages`` fresh (unbuffered) pages."""
        self._fault("read_run", int(n_pages))
        self.stats.reads += int(n_pages)

    def write(self, page_id: int) -> None:
        self.stats.writes += 1
        # A freshly written page is resident (it was produced in memory).
        self.buffer.touch(page_id)

    def write_seq(self, first_id: int, n_pages: int) -> None:
        """Write ``n_pages`` consecutive pages starting at ``first_id``.

        Accounting-equivalent to ``n_pages`` individual :meth:`write` calls in
        ascending id order (same write count, same final LRU state) but issued
        as one run-granular call so bulk writers avoid per-page call overhead.
        Runs longer than the buffer capacity skip the touch loop entirely:
        only the trailing ``capacity`` pages can remain resident.
        """
        n_pages = int(n_pages)
        self.stats.writes += n_pages
        cap = self.buffer.capacity
        if n_pages >= cap:
            self.buffer.load_run(range(first_id + n_pages - cap, first_id + n_pages))
            return
        for pid in range(first_id, first_id + n_pages):
            self.buffer.touch(pid)

    def write_run(self, n_pages: int) -> None:
        self.stats.writes += int(n_pages)

    # -- derived costs ----------------------------------------------------
    def external_sort_cost(self, n_pages: int, buffer_pages: int) -> IOStats:
        """I/O of textbook external merge sort of ``n_pages`` with an
        ``buffer_pages``-page buffer: run formation (read+write everything)
        plus ⌈log_{B-1}(P/B)⌉ merge passes, each reading+writing everything.

        This is charged (not executed) for the sort-based competitor loaders,
        mirroring how the paper accounts their construction cost.
        """
        import math

        p = max(int(n_pages), 1)
        b = max(int(buffer_pages), 2)
        if p <= b:  # fits in memory: single read pass, no spill
            return IOStats(reads=p, writes=0)
        runs = math.ceil(p / b)
        passes = max(1, math.ceil(math.log(max(runs, 2), b - 1)))
        # run formation (r+w) + merge passes (r+w each), final write included
        reads = p * (1 + passes)
        writes = p * (1 + passes)
        return IOStats(reads=reads, writes=writes)

    def charge(self, stats: IOStats) -> None:
        self.stats.reads += stats.reads
        self.stats.writes += stats.writes
