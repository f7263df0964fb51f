"""Stateless synthetic token pipeline (hash-counter based), a copy of the
reference's ``repro.data.pipeline``: the same bytes for the same arguments.

Real deployments swap in a tokenized corpus reader with the same interface;
determinism properties (resumable / elastic / host-local) are what the
runtime layer tests depend on.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _philox_like(seed: np.ndarray) -> np.ndarray:
    """Cheap counter-based mixing (splitmix64-style) on uint64 counters."""
    with np.errstate(over="ignore"):    # wrapping arithmetic is the point
        z = seed + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_slice(self, step: int, shard: int, n_shards: int):
        """Token/label arrays for one DP shard at one step.

        The mapping is a pure function of (step, global row) so any
        (shard, n_shards) factorization yields the same global batch.
        """
        assert self.global_batch % n_shards == 0
        rows = self.global_batch // n_shards
        row0 = shard * rows
        idx = (np.uint64(step) * np.uint64(self.global_batch)
               + np.arange(row0, row0 + rows, dtype=np.uint64))
        with np.errstate(over="ignore"):
            ctr = (idx[:, None] * np.uint64(self.seq_len + 1)
               + np.arange(self.seq_len + 1, dtype=np.uint64)
               + (np.uint64(self.seed) * np.uint64(0x5851F42D4C957F2D)))
        toks = (_philox_like(ctr) % np.uint64(self.vocab)).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def global_batch_at(self, step: int):
        return self.batch_slice(step, 0, 1)
