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
certified k-NN protocol) in each of those modes; the collective build
and rounds of the paper's Section 5 on a ``torch.distributed`` process
group, one rank per shard (``core.mesh``, ``core.distributed``);
the paper's NumPy engine and oracles, its competitor loaders
(``ALL_LOADERS``: Hilbert packing, STR, OMT, KDB, Waffle and FMBI) and
the Table-1 leaf metrics (``leaf_stats``); the brute-force count
``kernels.ops.window_count``; the retrieval path: the balanced
``GridIndex`` built on the device, its routing, window counts and k-NN,
served by ``RetrievalServer``; and the LM of every model config of the
repo (``configs``, ``models.LM``: dense, MoE, RWKV6, the Mamba hybrid,
the encoder-decoder, the VLM's patch front end) with greedy generation
(``LMServer``).  Ten hand-written Hopper kernels carry the index paths.
State carried across from the JAX package: ``index_from_arrays``,
``table_from_arrays``, ``grid_index_from_arrays`` and, for the LM,
``params_from_arrays``.  It imports ``torch`` and numpy only.
"""
from .core import (
    ALL_LOADERS,
    AMBI,
    LOADERS,
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
    grid_index_from_arrays,
    index_from_arrays,
    knn_oracle,
    knn_query,
    knn_query_batch_sharded,
    knn_query_batch_torch,
    leaf_stats,
    parallel_bulk_load,
    table_from_arrays,
    window_oracle,
    window_query,
    window_query_batch_sharded,
    window_query_batch_torch,
)
from .models import LM, params_from_arrays
from .serve import (
    DeviceQueryServer,
    DeviceQueryStats,
    FaultPlan,
    Frontend,
    LMServer,
    RetrievalServer,
    RetrievalStats,
    RetryPolicy,
)

__all__ = [
    "ALL_LOADERS",
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
    "LM",
    "LMServer",
    "LOADERS",
    "NodeTable",
    "PageStore",
    "RetrievalServer",
    "RetrievalStats",
    "RetryPolicy",
    "ShardedDeviceTable",
    "StreamingIndex",
    "bulk_load",
    "grid_index_from_arrays",
    "index_from_arrays",
    "knn_oracle",
    "knn_query",
    "knn_query_batch_sharded",
    "knn_query_batch_torch",
    "leaf_stats",
    "parallel_bulk_load",
    "params_from_arrays",
    "table_from_arrays",
    "window_oracle",
    "window_query",
    "window_query_batch_sharded",
    "window_query_batch_torch",
]
