"""Launcher for ``csrc/partition_assign.cu``: ``partition_assign`` on CUDA
tensors.

It replaces the JAX package's Pallas kernel ``partition_assign``
(``repro/kernels/partition_assign.py``).  The launcher checks its
arguments, allocates the output with ``torch.empty``, launches on the
current stream without synchronising, raises on a launch error and bumps
its launch count.  From ``SMEM_MIN_N`` points up the launch copies the
reachable split tables into each block's shared memory first; below it
each point reads them through L2, which costs less than the copy.
"""
from __future__ import annotations

import functools

import torch

from . import build, launches

MAX_LEVELS = 30  # leaf ids are int32
# the fewest points routed through the shared-memory tables: near the
# crossover measured on the H100 (PERF.md), where the 160 KB fill per
# block stops costing more than the L2 round trips it saves
SMEM_MIN_N = 160_000


@functools.cache
def _fn(symbol: str, n_ptrs: int, n_ints: int):
    return build.bind(build.library("partition_assign"), symbol, n_ptrs, n_ints)


def partition_assign(points, split_dim, split_val, *, levels: int) -> torch.Tensor:
    """(n,) int32 leaf id per point through the heap-form split tables;
    see ``ref.partition_assign_ref``."""
    n, d = points.shape
    n_levels, n_groups = split_dim.shape
    launches.check_dim(d)
    launches.check(points, "points", (torch.float32,), (n, d))
    launches.check(split_dim, "split_dim", (torch.int32,), (n_levels, n_groups))
    launches.check(split_val, "split_val", (torch.float32,), (n_levels, n_groups))
    launches.same_device(points, split_dim, split_val)
    if not 0 <= levels <= min(n_levels, MAX_LEVELS):
        raise ValueError(f"levels = {levels} outside [0, {min(n_levels, MAX_LEVELS)}]")
    if levels and n_groups < 1 << (levels - 1):
        raise ValueError(f"{levels} levels need {1 << (levels - 1)} groups per "
                         f"level, the tables have {n_groups}")
    launches.check_extents(n=n)
    out = torch.empty((n,), dtype=torch.int32, device=points.device)
    if n == 0:  # nothing to launch
        return out
    rc = _fn("partition_assign_launch", 4, 5)(
        points.data_ptr(), split_dim.data_ptr(), split_val.data_ptr(),
        out.data_ptr(), n, d, levels, n_groups, SMEM_MIN_N,
        torch.cuda.current_stream(points.device).cuda_stream,
    )
    launches.raise_on_error(rc, "partition_assign")
    launches.bump("partition_assign")
    return out
