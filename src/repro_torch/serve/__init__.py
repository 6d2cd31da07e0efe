"""Serving layer of the PyTorch port: greedy generation over the dense LM
(``LMServer``), window and k-NN serving over a
``NodeTable``, static, adaptive over AMBI or streaming
(``DeviceQueryServer``), with its resilience plane, fault injection,
graft journal and recovery, the async frontend in front of it
(``Frontend``), and batched k-NN retrieval over the balanced grid index
(``RetrievalServer``)."""
from .engine import (
    DeviceQueryServer,
    DeviceQueryStats,
    LMServer,
    RetrievalServer,
    RetrievalStats,
    StreamSyncError,
)
from .faults import FaultPlan, FaultRule
from .frontend import (
    Frontend,
    FrontendStats,
    InlineExecutor,
    Request,
    VirtualClock,
    WorkerExecutor,
)
from .journal import GraftJournal, JournalError
from .resilience import RetryPolicy

__all__ = [
    "DeviceQueryServer",
    "DeviceQueryStats",
    "FaultPlan",
    "FaultRule",
    "Frontend",
    "FrontendStats",
    "GraftJournal",
    "InlineExecutor",
    "JournalError",
    "LMServer",
    "Request",
    "RetrievalServer",
    "RetrievalStats",
    "RetryPolicy",
    "StreamSyncError",
    "VirtualClock",
    "WorkerExecutor",
]
