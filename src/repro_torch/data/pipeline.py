"""Data pipeline with FMBI spatial sharding (the paper as a data substrate).

Distributed training wants balanced, locality-preserving shards.  Documents
carry multidimensional keys (here: synthetic (length-score, domain-embedding)
coordinates); the paper's parallel bulk loader (Section 5) partitions them
across data-parallel workers with its balanced median SplitTree — max/mean
shard load ~1.06 in the paper, which is exactly the straggler-avoidance
property a pipeline needs (every DP worker finishes its epoch slice at the
same time).

The pipeline is deterministic and checkpointable: its state is
(epoch, cursor, seed), saved alongside model checkpoints.

The port's copy of the JAX package's ``data/pipeline.py``: NumPy over the
port's own ``core/splittree``; its shard assignment and batches equal the
reference's bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.splittree import build_group_median_tree


@dataclasses.dataclass
class PipelineState:
    epoch: int = 0
    cursor: int = 0
    seed: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


class TokenPipeline:
    """Synthetic-corpus pipeline: documents -> fixed-length token batches.

    ``n_shards`` data-parallel workers each stream only their FMBI-assigned
    document shard; ``shard_balance()`` reports the max/mean load.
    """

    def __init__(self, vocab: int, seq_len: int, n_docs: int = 2048,
                 n_shards: int = 1, seed: int = 0, doc_len_range=(64, 512)):
        self.vocab = vocab
        self.seq_len = seq_len
        self.n_shards = n_shards
        rng = np.random.default_rng(seed)
        lens = rng.integers(*doc_len_range, n_docs)
        # multidimensional document keys: (normalized length, 2-D embedding)
        keys = np.stack(
            [
                lens / doc_len_range[1],
                rng.random(n_docs),
                rng.random(n_docs),
            ],
            axis=1,
        ).astype(np.float64)
        if n_shards > 1:
            # paper Section 5: m-way SplitTree partition of the key space
            group = max(len(keys) // (n_shards * 8), 1)
            trim = n_shards * group * 8
            tree, _, assign = build_group_median_tree(
                keys[:trim], n_shards, group, 8
            )
            rest = tree.route(keys[trim:]) if trim < len(keys) else np.zeros(
                0, np.int32
            )
            self.shard_of = np.concatenate([assign, rest])
        else:
            self.shard_of = np.zeros(n_docs, dtype=np.int32)
        self.docs = [
            rng.integers(0, vocab, l).astype(np.int32) for l in lens
        ]
        self.state = PipelineState(seed=seed)

    def shard_balance(self) -> float:
        counts = np.bincount(self.shard_of, minlength=self.n_shards)
        return float(counts.max() / counts.mean())

    def _shard_tokens(self, shard: int) -> np.ndarray:
        docs = [d for d, s in zip(self.docs, self.shard_of) if s == shard]
        return (
            np.concatenate(docs) if docs else np.zeros(0, np.int32)
        )

    def next_batch(self, batch_per_shard: int, shard: int = 0) -> dict:
        """(batch_per_shard, seq_len) token/label arrays for one DP shard."""
        stream = self._shard_tokens(shard)
        need = batch_per_shard * self.seq_len
        out = np.empty(need, np.int32)
        got = 0
        cur = self.state.cursor
        while got < need:
            take = min(need - got, len(stream) - cur)
            if take <= 0:
                cur = 0
                self.state.epoch += 1
                continue
            out[got : got + take] = stream[cur : cur + take]
            got += take
            cur += take
        self.state.cursor = cur
        chunk = out.reshape(batch_per_shard, self.seq_len)
        # loss_fn shifts internally: labels == tokens stream
        return {"tokens": chunk, "labels": chunk.copy()}

    def global_batch(self, global_batch: int) -> dict:
        """Concatenated per-shard batches in shard order (DP layout)."""
        per = global_batch // self.n_shards
        parts = [self.next_batch(per, s) for s in range(self.n_shards)]
        return {
            k: np.concatenate([p[k] for p in parts]) for k in parts[0]
        }
