"""AMBI under a drifting workload on the PyTorch port: the index refines
only where queries go (paper Figures 6+8), converges to FMBI once the
workload covers space, and the refined table is served from the card.

    PYTHONPATH=src python examples/torch_adaptive_workload.py [--n 400000] [--device cuda]
"""
import argparse

import numpy as np

from repro_torch.core import AMBI, DeviceTable, PageStore, bulk_load, window_query_batch_torch
from repro_torch.core.datasets import osm_like


def count_unrefined(ambi):
    n = 0
    stack = [ambi.root]
    while stack:
        node = stack.pop()
        if node.is_unrefined:
            n += 1
        elif node.children:
            stack.extend(node.children)
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=400_000, help="dataset size")
    ap.add_argument("--device", default="cuda", help="where the refined index is served")
    args = ap.parse_args(argv)

    # float32-representable, as the card holds them
    points = osm_like(args.n, seed=0).astype(np.float32).astype(np.float64)
    M = 400
    ambi = AMBI(points, M)
    rng = np.random.default_rng(2)

    phases = [
        ("Germany-ish dense cluster", lambda: rng.random(2) * 0.06 + 0.60),
        ("second city",               lambda: rng.random(2) * 0.06 + 0.25),
        ("uniform everywhere",        lambda: rng.random(2) * 0.9 + 0.05),
    ]
    cum = 0
    for name, gen in phases:
        for _ in range(60):
            c = gen()
            _, io = ambi.window(c - 0.02, c + 0.02)
            cum += io.total
        print(f"after '{name}': cumulative I/O {cum:6d}, "
              f"unrefined regions left: {count_unrefined(ambi):3d}, "
              f"fully refined: {ambi.is_fully_refined()}")

    store = PageStore(M)
    bulk_load(points, M, store)
    print(f"\n(for scale: one-shot FMBI build costs {store.stats.total} I/Os)")

    # full coverage converges to the complete index
    for x in np.linspace(0.05, 0.95, 9):
        for y in np.linspace(0.05, 0.95, 9):
            ambi.window(np.array([x - 0.07, y - 0.07]), np.array([x + 0.07, y + 0.07]))
    print(f"after covering sweep: fully refined = {ambi.is_fully_refined()} "
          f"(AMBI -> FMBI, paper Fig 6c)")

    # the converged table, exported to the device engine
    dev = DeviceTable.from_table(ambi.table, ambi.points, device=args.device)
    c = rng.random((64, 2)) * 0.9
    # bounds rounded to float32 as well (the device engine compares in f32)
    los, his = ((c + s).astype(np.float32).astype(np.float64) for s in (-0.02, 0.02))
    got = window_query_batch_torch(dev, los, his)
    want = [ambi.window(lo, hi)[0] for lo, hi in zip(los, his)]
    same = all(np.array_equal(np.sort(a), np.sort(b)) for a, b in zip(got, want))
    print(f"served from {dev.device}: 64 windows answer as the host AMBI does: {same}")


if __name__ == "__main__":
    main()
