"""Serving layer of the PyTorch port: window and k-NN serving over a
``NodeTable``, static or adaptive over AMBI (``DeviceQueryServer``), with
its resilience plane and fault injection, and batched k-NN retrieval over
the balanced grid index (``RetrievalServer``)."""
from .engine import DeviceQueryServer, DeviceQueryStats, RetrievalServer, RetrievalStats
from .faults import FaultPlan, FaultRule
from .resilience import RetryPolicy

__all__ = [
    "DeviceQueryServer",
    "DeviceQueryStats",
    "FaultPlan",
    "FaultRule",
    "RetrievalServer",
    "RetrievalStats",
    "RetryPolicy",
]
