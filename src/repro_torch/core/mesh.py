"""Process groups for the collective rounds: one rank per shard.

The port's counterpart of the JAX package's device mesh (``jax.make_mesh``
with ``shard_map`` in ``repro/core/distributed.py``).  There, the mesh axis
plays the m local servers of the paper's Section 5; here each server is a
process of a ``torch.distributed`` group, started by :func:`run_ranks`.

  * :func:`run_ranks` starts ``world_size`` processes with the *spawn*
    start method (the parent may have done CUDA work, which a forked
    child cannot inherit), joins them through a ``file://`` store in a
    temporary directory (no port to pick), calls ``fn(group, *args)`` on
    each and returns each rank's result.  The first rank failure is raised
    in the parent as :class:`RankFailed`, naming the rank and carrying its
    traceback; a rank that dies or hangs never hangs the parent: the other
    ranks are killed and the parent raises within ``timeout`` seconds.
  * The caller names the backend and one device per rank; nothing picks
    either for it, and nothing moves to the CPU because a card is missing.
    NCCL runs each collective on the rank's card (one rank per card:
    NCCL refuses two ranks on one GPU).  Gloo runs it through host
    tensors: a CUDA tensor is staged with an explicit ``.cpu()`` and
    ``.to(device)`` in the helper below, and :attr:`Group.staged_bytes`
    counts what crossed.  A call that fails is raised, never retried
    on another backend.
  * :func:`all_gather` (concatenated by rank), :func:`all_to_all` (tiled
    over dim 0) and :func:`all_reduce_sum` are the only collectives.  Rank
    order is the JAX mesh axis order: the JAX side concatenates by
    ``axis_index``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import multiprocessing
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


class RankFailed(RuntimeError):
    """A rank raised, or exited before it reported a result."""

    def __init__(self, rank: int, detail: str):
        self.rank = int(rank)
        super().__init__(f"rank {rank} failed: {detail}")


@dataclasses.dataclass
class Group:
    """One rank's handle on its process group: its rank, the group's size,
    the backend and the device its tensors live on.  ``staged_bytes``
    counts the bytes that gloo collectives moved between the card and the
    host; ``seconds`` holds the spans timed with :meth:`timed`."""

    rank: int
    size: int
    backend: str
    device: torch.device
    staged_bytes: int = 0
    seconds: dict = dataclasses.field(default_factory=dict)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def timed(self, name: str):
        """Add the wall seconds of the block to ``seconds[name]``; on a card
        the block's device work is waited for at both ends."""
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0

    def _send(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor the backend takes: host memory for gloo, the rank's
        card for NCCL."""
        if t.device != self.device:
            raise ValueError(f"rank {self.rank}: tensor on {t.device}, the group's "
                             f"device is {self.device}")
        if self.backend == "nccl" or t.device.type == "cpu":
            return t.contiguous()
        self.staged_bytes += t.numel() * t.element_size()
        return t.cpu()

    def _recv(self, t: torch.Tensor) -> torch.Tensor:
        if t.device == self.device:
            return t
        self.staged_bytes += t.numel() * t.element_size()
        return t.to(self.device)


def all_gather(group: Group, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in rank
    order."""
    h = group._send(t)
    parts = [torch.empty_like(h) for _ in range(group.size)]
    dist.all_gather(parts, h)
    return group._recv(torch.cat(parts))


def all_to_all(group: Group, t: torch.Tensor) -> torch.Tensor:
    """Tiled all-to-all over dim 0: ``t`` splits into ``size`` equal
    blocks, block ``j`` goes to rank ``j``, and the result holds the
    blocks received, in rank order (``jax.lax.all_to_all`` with
    ``split_axis=0, concat_axis=0, tiled=True``)."""
    if t.shape[0] % group.size:
        raise ValueError(f"dim 0 ({t.shape[0]}) does not split over {group.size} ranks")
    h = group._send(t)
    out = torch.empty_like(h)
    dist.all_to_all_single(out, h)
    return group._recv(out)


def all_reduce_sum(group: Group, t: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of every rank's ``t`` (``t`` is left as it
    was)."""
    h = group._send(t).clone()
    dist.all_reduce(h, op=dist.ReduceOp.SUM)
    return group._recv(h)


def _rank_main(fn, rank, size, backend, device, init_method, timeout, args, results):
    """One rank: join the group, run ``fn`` and report ``(rank, ok,
    result or traceback)`` to the parent."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, world_size=size,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout))
        out = fn(Group(rank, size, backend, dev), *args)
        dist.destroy_process_group()
    except Exception:  # the rank's boundary: the parent raises it
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, out))


def _next_report(results, procs, pending, deadline, timeout):
    """The next ``(rank, ok, payload)`` report; raises when a pending rank
    exited without one or the deadline passed."""
    while True:
        try:
            return results.get(timeout=0.2)
        except queue.Empty:
            pass
        dead = [r for r in sorted(pending) if procs[r].exitcode is not None]
        if dead:
            try:  # a report written just before the exit may still be in flight
                return results.get(timeout=2.0)
            except queue.Empty:
                raise RankFailed(dead[0], f"exited with code {procs[dead[0]].exitcode} "
                                          f"before reporting a result") from None
        if time.monotonic() > deadline:
            raise TimeoutError(f"ranks {sorted(pending)} reported no result within "
                               f"{timeout} s")


def _silent_deaths(procs, ranks, grace: float) -> list:
    """The ranks among ``ranks`` that exited with a nonzero code, waiting
    up to ``grace`` seconds for one to appear."""
    end = time.monotonic() + grace
    while True:
        dead = [r for r in sorted(ranks) if procs[r].exitcode not in (None, 0)]
        if dead or time.monotonic() > end:
            return dead
        time.sleep(0.05)


def run_ranks(fn, world_size: int, *, backend: str, devices, args=(),
              timeout: float = 600.0) -> list:
    """Run ``fn(group, *args)`` on ``world_size`` spawned ranks and return
    their results in rank order.

    ``fn`` must be a module-level function importable without the caller's
    ``__main__`` state, and its result picklable (NumPy arrays and plain
    Python values; never a CUDA tensor).  ``devices`` names one device per
    rank.  ``timeout`` bounds the whole run and each collective.  The first
    failure raises :class:`RankFailed` (or ``TimeoutError``); every rank is
    stopped before this returns or raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    devices = [torch.device(d) for d in devices]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    if backend == "nccl" and any(d.type != "cuda" for d in devices):
        raise ValueError("the NCCL backend needs a CUDA device on every rank")
    if any(d.type == "cuda" and d.index is None for d in devices):
        raise ValueError("name each rank's card with its index, e.g. cuda:0")
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_group_")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, name=f"rank{r}", daemon=True,
                    args=(fn, r, world_size, backend, str(devices[r]),
                          f"file://{tmp}/store", timeout, args, results))
        for r in range(world_size)
    ]
    out = [None] * world_size
    try:
        for p in procs:
            p.start()
        pending = set(range(world_size))
        deadline = time.monotonic() + timeout
        while pending:
            rank, ok, payload = _next_report(results, procs, pending, deadline, timeout)
            if not ok:
                # a rank that died without a report (a nonzero exit code)
                # is what made the others' collectives fail: name it; give
                # such a death a moment to show
                silent = _silent_deaths(procs, pending - {rank}, grace=1.0)
                if silent:
                    raise RankFailed(silent[0], f"exited with code "
                                     f"{procs[silent[0]].exitcode} before reporting a "
                                     f"result; rank {rank} failed after it:\n{payload}")
                raise RankFailed(rank, "\n" + payload)
            out[rank] = payload
            pending.discard(rank)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=30)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out
