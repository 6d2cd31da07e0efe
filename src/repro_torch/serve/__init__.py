"""Serving layer of the PyTorch port: batched k-NN retrieval over the
balanced grid index (``RetrievalServer``)."""
from .engine import RetrievalServer, RetrievalStats

__all__ = ["RetrievalServer", "RetrievalStats"]
