"""FMBI (the paper's Section 3): the whole index bulk loaded on the host,
then exported to the card at once; the served index is in place after the
export."""
from __future__ import annotations

import time

import torch

from .. import harness
from . import Built

WARMUP_REQUESTS = 0


def deploy(cfg: dict, pts, device, microbatch: int) -> Built:
    import repro_torch as rt

    setup = {}
    t = time.perf_counter()
    bp = harness.buffer_pages(cfg, len(pts))
    idx = rt.bulk_load(pts, bp, rt.PageStore(bp))
    setup["bulk_load_s"] = time.perf_counter() - t
    if idx.leaf_cap != cfg["leaf_capacity"]:
        raise RuntimeError(f"leaf capacity {idx.leaf_cap}, configured {cfg['leaf_capacity']}")
    on_card = torch.device(device).type == "cuda"
    harness.sync(device)
    before = torch.cuda.memory_allocated() if on_card else None
    t = time.perf_counter()
    srv = rt.DeviceQueryServer.from_index(idx, microbatch=microbatch,
                                          compressed=cfg["export"] != "float32",
                                          device=device)
    harness.sync(device)
    setup["export_s"] = time.perf_counter() - t
    return Built(
        index=idx, server=srv, store=idx.store, setup=setup, buffer_pages=bp,
        device_bytes=torch.cuda.memory_allocated() - before if on_card else None)
