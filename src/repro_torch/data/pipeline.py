"""Deterministic data pipeline with skip-ahead resume.

A copy of `src/repro/data/pipeline.py` (`TokenStream` :18, `make_lm_stream`
:49, `global_batch_iterator` :56), numpy only. Every batch is a pure function of (seed, step, shard), so
resume after preemption is exact and the port reads the same batches as
the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class TokenStream:
    """Infinite LM token stream over a (possibly synthetic) corpus."""
    corpus: np.ndarray            # [num_seqs, seq_len+1] int32
    batch_size: int               # per-shard batch
    shard: int = 0
    num_shards: int = 1
    seed: int = 0

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Deterministic batch for a global step. O(1) — supports skip-ahead."""
        n = self.corpus.shape[0]
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard)
        idx = rng.integers(0, n, size=self.batch_size)
        seqs = self.corpus[idx]
        return {"tokens": seqs[:, :-1].astype(np.int32),
                "labels": seqs[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def iter_from(self, start_step: int) -> Iterator[dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def make_lm_stream(corpus_tokens: np.ndarray, batch_size: int, *,
                   shard: int = 0, num_shards: int = 1,
                   seed: int = 0) -> TokenStream:
    assert corpus_tokens.ndim == 2
    return TokenStream(corpus_tokens, batch_size, shard, num_shards, seed)


def global_batch_iterator(corpus: np.ndarray, global_batch: int,
                          num_shards: int, seed: int = 0,
                          start_step: int = 0):
    """Host-side view of the full global batch (single-process simulation of
    what each shard would read) — used by the CPU training examples."""
    per = global_batch // num_shards
    streams = [make_lm_stream(corpus, per, shard=s, num_shards=num_shards,
                              seed=seed) for s in range(num_shards)]
    step = start_step
    while True:
        parts = [st.batch_at(step) for st in streams]
        yield {k: np.concatenate([p[k] for p in parts], 0) for k in parts[0]}
        step += 1
