"""AMBI (the paper's Section 4): the card boots from one unrefined root
(a partial export of one cold row), and the index grows where queries
land: each cold query is answered on the host, which grafts the subspaces
it touched, and the grafts reach the card as deltas.  So the served index
is in place only once the warm-up's requests have refined it, and the
set-up holds the boot and that refinement: the paper's combined cost."""
from __future__ import annotations

import time

from .. import harness
from . import Built

# served before the warm-up's timed floor; under focused traffic the first
# request refines the focus and the rest find few cold queries
WARMUP_REQUESTS = 8


def deploy(cfg: dict, pts, device, microbatch: int) -> Built:
    import repro_torch as rt

    bp = harness.buffer_pages(cfg, len(pts))
    before = harness.card_bytes(device)
    t = time.perf_counter()
    ambi = rt.AMBI(pts, bp, rt.PageStore(bp))
    if ambi.c_l != cfg["leaf_capacity"]:
        raise RuntimeError(f"leaf capacity {ambi.c_l}, configured {cfg['leaf_capacity']}")
    srv = rt.DeviceQueryServer.from_ambi(ambi, microbatch=microbatch,
                                         compressed=cfg["export"] != "float32",
                                         device=device)
    harness.sync(device)
    return Built(index=ambi, server=srv, store=ambi.store,
                 setup={"boot_s": time.perf_counter() - t}, buffer_pages=bp,
                 bytes_before=before)
