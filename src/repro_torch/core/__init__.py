"""Host layers (copies of the JAX package's NumPy modules) and the device
query engine of the port."""
from .convert import index_from_arrays, table_from_arrays
from .fmbi import Index, Node, bulk_load, merge_branches, refine_subspace
from .nodetable import NodeTable, NodeView, compress_boxes_bf16
from .pagestore import IOStats, PageStore, branch_capacity, leaf_capacity
from .queries_torch import (
    DeviceTable,
    UploadStats,
    knn_query_batch_torch,
    window_query_batch_torch,
)

__all__ = [
    "DeviceTable",
    "Index",
    "IOStats",
    "Node",
    "NodeTable",
    "NodeView",
    "PageStore",
    "UploadStats",
    "branch_capacity",
    "bulk_load",
    "compress_boxes_bf16",
    "index_from_arrays",
    "knn_query_batch_torch",
    "leaf_capacity",
    "merge_branches",
    "refine_subspace",
    "table_from_arrays",
    "window_query_batch_torch",
]
