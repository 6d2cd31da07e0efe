"""Launch counters and argument checks shared by the CUDA launchers.

Each launcher adds one to its kernel's count where it launches the kernel
and nowhere else, so a run can show that its main path went through the
kernels: zero the counts with :func:`reset`, drive the path, read them
with :func:`counts`.  The counts live in the port's process-wide counter
registry (``repro_torch.tracing``), under ``launch.<kernel>``.
"""
from __future__ import annotations

import torch

from .. import tracing

KERNELS = ("box_hits", "pair_window_ids", "leaf_mindist", "pair_dist2",
           "partition_assign", "window_count_gathered", "pairwise_dist2",
           "gathered_dist2", "window_mask_gathered", "window_count_tiles")
MAX_D = 64      # the CUDA sources stage at most this many dimensions
INT32_MAX = 2**31 - 1

_KEYS = {k: "launch." + k for k in KERNELS}


def bump(name: str) -> None:
    tracing.count(_KEYS[name])


def counts() -> dict:
    """A copy of the launch counts."""
    c = tracing.counters()
    return {k: c.get(key, 0) for k, key in _KEYS.items()}


def reset() -> None:
    tracing.zero_counters("launch.")


def check(t: torch.Tensor, what: str, dtypes, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``
    with ``shape`` (``None`` entries match any extent)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    ):
        raise ValueError(f"{what}: shape {tuple(t.shape)} does not match {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def check_extents(**extents: int) -> None:
    """Raise if a size does not fit the kernels' int32 launch interface."""
    for what, n in extents.items():
        if n > INT32_MAX:
            raise ValueError(f"{what} = {n} exceeds the int32 launch interface")


def check_dim(d: int) -> None:
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the CUDA kernels take 1 <= d <= {MAX_D}, got d = {d}")


def raise_on_error(rc: int, kernel: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaGetLastError() = {rc}")


def same_device(*ts: torch.Tensor) -> None:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
