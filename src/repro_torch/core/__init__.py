"""Host layers (copies of the JAX package's NumPy modules: FMBI, AMBI,
streaming ingest, parallel bulk loading and the NumPy query engine among
them), the device query engine, its sharded form and the balanced grid
index of the port."""
from .ambi import AMBI
from .convert import grid_index_from_arrays, index_from_arrays, table_from_arrays
from .distributed import ParallelBuild, parallel_bulk_load, parallel_window_cost
from .distributed_torch import (
    CompletenessCertificate,
    ShardedDeviceTable,
    ShardUnavailable,
    knn_query_batch_sharded,
    window_query_batch_sharded,
)
from .grid_index import GridIndex
from .fmbi import Index, Node, bulk_load, merge_branches, refine_subspace
from .nodetable import NodeTable, NodeView, compress_boxes_bf16
from .pagestore import IOStats, PageStore, branch_capacity, leaf_capacity
from .queries import (
    knn_oracle,
    knn_query,
    knn_query_batch,
    window_oracle,
    window_query,
    window_query_batch,
)
from .queries_torch import (
    DeviceTable,
    UploadStats,
    knn_query_batch_torch,
    window_query_batch_torch,
)
from .streaming import DeviceMirror, StreamingIndex

__all__ = [
    "AMBI",
    "CompletenessCertificate",
    "DeviceMirror",
    "DeviceTable",
    "GridIndex",
    "Index",
    "IOStats",
    "knn_oracle",
    "knn_query",
    "knn_query_batch",
    "Node",
    "NodeTable",
    "NodeView",
    "PageStore",
    "ParallelBuild",
    "ShardedDeviceTable",
    "UploadStats",
    "branch_capacity",
    "bulk_load",
    "compress_boxes_bf16",
    "grid_index_from_arrays",
    "index_from_arrays",
    "knn_query_batch_sharded",
    "knn_query_batch_torch",
    "leaf_capacity",
    "merge_branches",
    "parallel_bulk_load",
    "parallel_window_cost",
    "refine_subspace",
    "ShardUnavailable",
    "StreamingIndex",
    "table_from_arrays",
    "window_oracle",
    "window_query",
    "window_query_batch",
    "window_query_batch_sharded",
    "window_query_batch_torch",
]
