"""Synthetic LM corpora with paper-matched statistics.

A copy of `src/repro/data/synthetic.py` (`ZipfLM` :18, `zipf_tokens` :73),
numpy only: `repro/__init__.py` imports jax, so the port keeps its own copy
instead of importing it. The same seed gives the same corpus as the
reference, bit for bit. The RecSys and XMC generators are not copied yet.

- Zipf LM: a latent-cluster bigram language — context determines a cluster
  of plausible next tokens (so adaptive samplers have structure to
  exploit) with a Zipf marginal (so unigram beats uniform, as in the paper).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ZipfLM:
    vocab_size: int
    num_clusters: int
    seq_len: int
    zipf_a: float = 1.2
    within_cluster_noise: float = 0.15
    seed: int = 0

    def _tables(self):
        rng = np.random.default_rng(self.seed)
        v, c = self.vocab_size, self.num_clusters
        token_cluster = rng.integers(0, c, size=v)
        # cluster transition matrix (sparse-ish, row-stochastic)
        trans = rng.dirichlet(np.ones(c) * 0.3, size=c)
        # zipf marginal over tokens, renormalized within cluster
        ranks = np.arange(1, v + 1)
        zipf = ranks ** (-self.zipf_a)
        rng.shuffle(zipf)
        within = np.zeros((c, v))
        for k in range(c):
            m = token_cluster == k
            w = zipf * m
            if w.sum() == 0:
                # cluster with no assigned tokens (small vocab / many
                # clusters): fall back to the global marginal so the row
                # stays stochastic instead of dividing to NaN
                w = m.astype(float) if m.any() else zipf.copy()
            within[k] = w / w.sum()
        return token_cluster, trans, within, zipf / zipf.sum()

    def sample(self, num_seqs: int, seed: int | None = None) -> np.ndarray:
        """Returns int32 [num_seqs, seq_len]."""
        token_cluster, trans, within, marginal = self._tables()
        rng = np.random.default_rng(self.seed + 1 if seed is None else seed)
        v, c = self.vocab_size, self.num_clusters
        out = np.empty((num_seqs, self.seq_len), np.int32)
        cur = rng.integers(0, c, size=num_seqs)
        for t in range(self.seq_len):
            # mostly stay coherent with the cluster chain, sometimes noise
            probs = within[cur]
            noise = rng.random(num_seqs) < self.within_cluster_noise
            tok_coherent = np.array(
                [rng.choice(v, p=probs[i]) for i in range(num_seqs)])
            tok_noise = rng.choice(v, p=marginal, size=num_seqs)
            tok = np.where(noise, tok_noise, tok_coherent)
            out[:, t] = tok
            nxt = np.array([rng.choice(c, p=trans[token_cluster[tok[i]]])
                            for i in range(num_seqs)])
            cur = nxt
        return out

    def unigram_counts(self, tokens: np.ndarray) -> np.ndarray:
        return np.bincount(tokens.reshape(-1), minlength=self.vocab_size)


def zipf_tokens(num_seqs: int, seq_len: int, vocab: int, a: float = 1.2,
                seed: int = 0) -> np.ndarray:
    """Fast i.i.d. Zipf token stream (for throughput-oriented benchmarks)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    p = ranks ** (-a)
    p /= p.sum()
    perm = rng.permutation(vocab)
    toks = rng.choice(vocab, p=p, size=(num_seqs, seq_len))
    return perm[toks].astype(np.int32)
