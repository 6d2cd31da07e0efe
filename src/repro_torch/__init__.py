"""PyTorch and CUDA port of the FMBI/AMBI reproduction (``repro``).

It carries the main path: the FMBI bulk load on the host, the device
export (``DeviceTable``) and the window and k-NN batches (fused, or the
first generation with ``fused=False``); serving through
``DeviceQueryServer``, static or adaptive over AMBI (hot queries on the
card's partial export, cold ones refined by the host engine, grafts
uploaded as deltas) or streaming over a live ``StreamingIndex``
(inserts and deletes, its tiers mirrored on the card), with a graft
journal, snapshot barriers and recovery, behind the async ``Frontend``;
sharded serving (``ShardedDeviceTable``: m per-shard exports behind a
router, windows fanned out to the qualified shards, the two-round
certified k-NN protocol) in each of those modes;
the paper's NumPy engine and oracles; the
brute-force count ``kernels.ops.window_count``; and the retrieval path:
the balanced ``GridIndex`` built on the device, its routing, window
counts and k-NN, served by ``RetrievalServer``.  Ten hand-written Hopper
kernels carry them.  It imports ``torch`` and numpy only.
"""
from .core import (
    AMBI,
    CompletenessCertificate,
    DeviceTable,
    GridIndex,
    Index,
    IOStats,
    NodeTable,
    PageStore,
    ShardedDeviceTable,
    StreamingIndex,
    bulk_load,
    knn_oracle,
    knn_query,
    knn_query_batch_sharded,
    knn_query_batch_torch,
    parallel_bulk_load,
    window_oracle,
    window_query,
    window_query_batch_sharded,
    window_query_batch_torch,
)
from .serve import (
    DeviceQueryServer,
    DeviceQueryStats,
    FaultPlan,
    Frontend,
    RetrievalServer,
    RetrievalStats,
    RetryPolicy,
)

__all__ = [
    "AMBI",
    "CompletenessCertificate",
    "DeviceQueryServer",
    "DeviceQueryStats",
    "DeviceTable",
    "FaultPlan",
    "Frontend",
    "GridIndex",
    "Index",
    "IOStats",
    "NodeTable",
    "PageStore",
    "RetrievalServer",
    "RetrievalStats",
    "RetryPolicy",
    "ShardedDeviceTable",
    "StreamingIndex",
    "bulk_load",
    "knn_oracle",
    "knn_query",
    "knn_query_batch_sharded",
    "knn_query_batch_torch",
    "parallel_bulk_load",
    "window_oracle",
    "window_query",
    "window_query_batch_sharded",
    "window_query_batch_torch",
]
