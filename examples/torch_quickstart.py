"""Quickstart on the PyTorch port: bulk load FMBI, query it, compare
against the sort-based competitors, serve a window batch from the card,
and peek at the adaptive variant.

    PYTHONPATH=src python examples/torch_quickstart.py [--n 300000] [--device cuda]

``--device cpu`` runs the device engine's plain PyTorch versions on the
CPU instead of the CUDA kernels.
"""
import argparse
import pathlib
import tempfile

import numpy as np

from repro_torch.core import (
    ALL_LOADERS,
    AMBI,
    DeviceTable,
    Index,
    PageStore,
    bulk_load,
    knn_query,
    leaf_stats,
    window_query,
    window_query_batch,
    window_query_batch_torch,
)
from repro_torch.core.datasets import osm_like


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=300_000, help="dataset size")
    ap.add_argument("--device", default="cuda", help="where the device engine runs")
    args = ap.parse_args(argv)

    print("generating an OSM-like dataset (dense cities, empty oceans)...")
    # float32-representable, as the card holds them: the device engine then
    # answers exactly as the host engine does
    points = osm_like(args.n, seed=0).astype(np.float32).astype(np.float64)
    buffer_pages = 400  # ~4.5% of the 300k-point dataset's 880 pages

    # ---- full bulk loading (paper Section 3) ----------------------------
    store = PageStore(buffer_pages)
    index = bulk_load(points, buffer_pages, store)
    stats = leaf_stats(index)
    print(f"\nFMBI built with {store.stats.total} page I/Os "
          f"({store.stats.reads} reads / {store.stats.writes} writes)")
    print(f"  leaves={stats.count}  fill={stats.avg_fill:.2f}  "
          f"area={stats.total_area:.4f}  balance={stats.max_over_mean:.3f}")

    # ---- queries ---------------------------------------------------------
    res, io = window_query(index, np.array([0.6, 0.6]), np.array([0.63, 0.63]))
    print(f"\nwindow [0.60,0.63]^2 -> {len(res)} points, {io.total} page I/Os")
    rows, io = knn_query(index, np.array([0.5, 0.5]), 16)
    print(f"16-NN of (0.5,0.5) -> {io.total} page I/Os")

    # ---- vs sort-based competitors ---------------------------------------
    print("\nconstruction cost (page I/O):")
    for name, loader in sorted(ALL_LOADERS.items()):
        st = PageStore(buffer_pages)
        loader(points, buffer_pages, st)
        print(f"  {name:8s} {st.stats.total:7d}")

    # ---- batched queries over the flat node table ------------------------
    rng = np.random.default_rng(1)
    centers = rng.random((32, 2)) * 0.9
    # bounds rounded to float32 as well (the device engine compares in f32)
    los, his = ((centers + s).astype(np.float32).astype(np.float64) for s in (-0.02, 0.02))
    res_b, io_b = window_query_batch(index, los, his)
    print(f"\n32-window batch (one frontier traversal) -> "
          f"{sum(len(r) for r in res_b)} points, {io_b.total} page I/Os")

    # ---- the same batch from the device engine ---------------------------
    dev = DeviceTable.from_index(index, device=args.device)
    res_d = window_query_batch_torch(dev, los, his)
    same = all(np.array_equal(np.sort(a), np.sort(b)) for a, b in zip(res_d, res_b))
    print(f"device engine on {dev.device}: {dev.n_leaves} leaves exported; "
          f"the 32 windows answer identically: {same}")

    # ---- snapshot the flat index (single .npz), reload, query ------------
    t = index.table
    print(f"\nflat node table: {t.n_nodes} rows, {t.n_perm} perm entries")
    with tempfile.TemporaryDirectory() as tmp:
        snap = pathlib.Path(tmp) / "fmbi.npz"
        index.save(snap)
        loaded = Index.load(snap)
        res2, _ = window_query(loaded, np.array([0.6, 0.6]), np.array([0.63, 0.63]))
        same = sorted(res2.tolist()) == sorted(res.tolist())
        print(f"snapshot -> {snap.stat().st_size/1e6:.1f} MB; reloaded index "
              f"answers identically: {same}")

    # ---- adaptive bulk loading (paper Section 4) -------------------------
    ambi = AMBI(points, buffer_pages)
    cum = 0
    for _ in range(10):
        c = rng.random(2) * 0.08 + 0.55
        _, io = ambi.window(c - 0.02, c + 0.02)
        cum += io.total
    print(f"\nAMBI: 10 focused windows cost {cum} page I/Os total "
          f"(vs {store.stats.total} for the full FMBI build alone); "
          f"fully refined: {ambi.is_fully_refined()}")


if __name__ == "__main__":
    main()
