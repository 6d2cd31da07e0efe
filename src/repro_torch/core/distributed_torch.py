"""Degraded-mode protocol types of the sharded engine: shard outages and
completeness certificates.

The port's counterparts of ``ShardUnavailable`` and
``CompletenessCertificate`` in the JAX package's
``repro/core/distributed_jax.py``.  Single-device serving
(``serve/engine.py:DeviceQueryServer``) already speaks this protocol: its
one device is shard 0, and a whole-device outage comes back as an
incomplete certificate over the root box.  The sharded engine itself
(``ShardedDeviceTable`` and the two-round protocol) joins these types in a
later slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class ShardUnavailable(RuntimeError):
    """A shard cannot serve (dispatch failed past retry / breaker open).

    Raised *into* the query protocols by the injected ``runner``; with
    ``return_certs=True`` the server degrades (answers from the remaining
    shards + a per-query certificate), without it the outage propagates
    to the caller unchanged.
    """

    def __init__(self, shard: int, reason: str = ""):
        self.shard = int(shard)
        super().__init__(
            f"shard {shard} unavailable" + (f": {reason}" if reason else "")
        )


@dataclasses.dataclass
class CompletenessCertificate:
    """Per-query provenance of a (possibly degraded) answer.

    ``complete`` — every shard relevant to this query answered; the result
    is exactly the healthy protocol's.  ``certified_exact`` — the returned
    ids are provably the exact answer even if shards were down: trivially
    true when complete.  ``missing_shards`` / ``missing_lo`` /
    ``missing_hi`` are the unanswered subspaces that *could* affect the
    answer (empty iff ``certified_exact``): the repair queue, and for a
    window query the region the caller must treat as unknown.
    """

    complete: bool
    certified_exact: bool
    missing_shards: tuple = ()
    missing_lo: np.ndarray = None  # (u, d) f32 boxes, one row per subspace
    missing_hi: np.ndarray = None

    @classmethod
    def intact(cls) -> "CompletenessCertificate":
        return cls(complete=True, certified_exact=True)
