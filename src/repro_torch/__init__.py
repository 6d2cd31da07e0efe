"""PyTorch and CUDA port of the FMBI/AMBI reproduction (``repro``).

It carries the main path: the FMBI bulk load on the host, the device
export (``DeviceTable``) and the fused window and k-NN batches; and the
retrieval path: the balanced ``GridIndex`` built on the device, its
routing, window counts and k-NN, served by ``RetrievalServer``.  Eight
hand-written Hopper kernels carry both.  It imports ``torch`` and numpy
only.
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
