"""Synthetic LM corpora with paper-matched statistics.

A copy of `src/repro/data/synthetic.py` (`ZipfLM` :18, `zipf_tokens` :73,
`recsys_interactions` :85, `xmc_dataset` :100), numpy only:
`repro/__init__.py` imports jax, so the port keeps its own copy instead of
importing it. The same seed gives the same data as the reference, bit for
bit; `ZipfLM.sample` departs in how it gets there (one CDF per cluster,
built once, where the reference rebuilds one per token), which makes a
512 x 4097 corpus at V = 128 256 a matter of seconds.

- Zipf LM: a latent-cluster bigram language — context determines a cluster
  of plausible next tokens (so adaptive samplers have structure to
  exploit) with a Zipf marginal (so unigram beats uniform, as in the paper).
- RecSys: latent-factor user/item interactions (SASRec/GRU4Rec task shape).
- XMC: sparse BOW features with clustered label embeddings.
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
        """Returns int32 [num_seqs, seq_len], bit for bit the reference's
        draw. The reference calls `rng.choice(v, p=row)` once per token,
        which rebuilds the row's CDF each time (O(V) a token). Here each
        cluster's CDF is built once, the same way (`cumsum`, then divided
        by its last entry), and the same uniforms, drawn in the same order
        (per step: the noise mask, the coherent draws, the marginal draws,
        the cluster transitions; n each), are mapped with
        `searchsorted(..., side="right")`, as `Generator.choice` maps them."""
        token_cluster, trans, within, marginal = self._tables()
        rng = np.random.default_rng(self.seed + 1 if seed is None else seed)
        c = self.num_clusters
        n = num_seqs
        within_cdf = [_cdf(row) for row in within]
        trans_cdf = [_cdf(row) for row in trans]
        marginal_cdf = _cdf(marginal)
        out = np.empty((n, self.seq_len), np.int32)
        cur = rng.integers(0, c, size=n)
        for t in range(self.seq_len):
            u = rng.random((4, n))
            noise = u[0] < self.within_cluster_noise
            tok_coherent = _choose(within_cdf, cur, u[1])
            tok_noise = marginal_cdf.searchsorted(u[2], side="right")
            tok = np.where(noise, tok_noise, tok_coherent)
            out[:, t] = tok
            cur = _choose(trans_cdf, token_cluster[tok], u[3])
        return out

    def unigram_counts(self, tokens: np.ndarray) -> np.ndarray:
        return np.bincount(tokens.reshape(-1), minlength=self.vocab_size)


def _cdf(p: np.ndarray) -> np.ndarray:
    """The CDF `Generator.choice(..., p=p)` builds from p."""
    cdf = np.cumsum(p)
    cdf /= cdf[-1]
    return cdf


def _choose(cdfs: list, rows: np.ndarray, u: np.ndarray) -> np.ndarray:
    """out[i] = the draw of uniform u[i] under cdfs[rows[i]]."""
    out = np.empty(rows.shape, np.int64)
    for r in np.unique(rows):
        sel = rows == r
        out[sel] = cdfs[r].searchsorted(u[sel], side="right")
    return out


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


def recsys_interactions(num_users: int, num_items: int, seq_len: int,
                        d_latent: int = 16, seed: int = 0) -> np.ndarray:
    """User behaviour sequences from a latent-factor model. [U, seq_len] int32."""
    rng = np.random.default_rng(seed)
    users = rng.normal(size=(num_users, d_latent))
    items = rng.normal(size=(num_items, d_latent))
    # drift: each user vector takes a small random walk per step
    out = np.empty((num_users, seq_len), np.int32)
    for t in range(seq_len):
        scores = users @ items.T + rng.gumbel(size=(num_users, num_items)) * 2.0
        out[:, t] = scores.argmax(-1)
        users = users + 0.15 * rng.normal(size=users.shape)
    return out


def xmc_dataset(num_samples: int, num_labels: int, feat_dim: int,
                nnz: int = 20, num_clusters: int = 32, seed: int = 0):
    """Sparse BOW features + clustered labels.

    Returns (features [S, feat_dim] float32 dense-ified, labels [S] int32).
    """
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(num_clusters, feat_dim)) * 2.0
    label_cluster = rng.integers(0, num_clusters, size=num_labels)
    label_vecs = centers[label_cluster] + 0.3 * rng.normal(
        size=(num_labels, feat_dim))
    labels = rng.integers(0, num_labels, size=num_samples)
    feats = label_vecs[labels] + 0.5 * rng.normal(
        size=(num_samples, feat_dim))
    # sparsify: keep top-|nnz| magnitude dims per sample
    idx = np.argsort(-np.abs(feats), axis=1)[:, nnz:]
    np.put_along_axis(feats, idx, 0.0, axis=1)
    return feats.astype(np.float32), labels.astype(np.int32)
