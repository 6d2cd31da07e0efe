"""PyTorch and CUDA port of the FMBI/AMBI reproduction (``repro``).

This slice carries the main path: the FMBI bulk load on the host, the
device export (``DeviceTable``) and the fused window and k-NN batches on
four hand-written Hopper kernels.  It imports ``torch`` and numpy only.
"""
from .core import (
    DeviceTable,
    Index,
    IOStats,
    NodeTable,
    PageStore,
    bulk_load,
    knn_query_batch_torch,
    window_query_batch_torch,
)

__all__ = [
    "DeviceTable",
    "Index",
    "IOStats",
    "NodeTable",
    "PageStore",
    "bulk_load",
    "knn_query_batch_torch",
    "window_query_batch_torch",
]
