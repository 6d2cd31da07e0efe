"""PyTorch and CUDA port of the FMBI/AMBI reproduction (``repro``).

It carries the main path: the FMBI bulk load on the host, the device
export (``DeviceTable``) and the window and k-NN batches (fused, or the
first generation with ``fused=False``); the brute-force count
``kernels.ops.window_count``; and the retrieval path: the balanced
``GridIndex`` built on the device, its routing, window counts and k-NN,
served by ``RetrievalServer``.  Ten hand-written Hopper kernels carry
them.  It imports ``torch`` and numpy only.
"""
from .core import (
    DeviceTable,
    GridIndex,
    Index,
    IOStats,
    NodeTable,
    PageStore,
    bulk_load,
    knn_query_batch_torch,
    window_query_batch_torch,
)
from .serve import RetrievalServer, RetrievalStats

__all__ = [
    "DeviceTable",
    "GridIndex",
    "Index",
    "IOStats",
    "NodeTable",
    "PageStore",
    "RetrievalServer",
    "RetrievalStats",
    "bulk_load",
    "knn_query_batch_torch",
    "window_query_batch_torch",
]
