"""Product / residual quantizers for the inverted multi-index (paper §4.1).

Mirrors `src/repro/index/quantization.py` (`reconstruct` :51, `fit_pq`
:60, `fit_rq` :77, `fit` :90, `assign_against` :99, `query_scores` :118). Both
quantizers give two codebooks of K codewords, assignments (k1, k2) per class
and residuals, and score a query z as
  PQ: z split into halves, s_l[k] = <z_l, c_l[k]>   (codewords in R^{D/2})
  RQ: full z against both,  s_l[k] = <z,  c_l[k]>   (codewords in R^D)
so that o_i = z·q_i = s1[k1(i)] + s2[k2(i)] + z·q~_i (Theorem 1).
Departure: the two K-means stages draw from one `torch.Generator` in turn
where the reference splits a JAX key.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.index.kmeans import _assign, kmeans


@dataclasses.dataclass(frozen=True)
class Quantization:
    kind: str                    # 'pq' | 'rq'
    codebook1: torch.Tensor      # PQ: [K, D/2]; RQ: [K, D]
    codebook2: torch.Tensor      # PQ: [K, D/2]; RQ: [K, D]
    assign1: torch.Tensor        # [N] int64
    assign2: torch.Tensor        # [N] int64
    residuals: torch.Tensor      # [N, D]

    @property
    def num_codewords(self) -> int:
        return self.codebook1.shape[0]


def reconstruct(kind: str, codebook1, codebook2, assign1, assign2):
    """Reconstructed class embeddings from codeword assignments."""
    if kind == "pq":
        return torch.cat([codebook1[assign1], codebook2[assign2]], dim=-1)
    return codebook1[assign1] + codebook2[assign2]


def fit_pq(gen: torch.Generator, q: torch.Tensor, k: int, iters: int = 10,
           init: Optional[tuple] = None) -> Quantization:
    """Product quantization: split D into two halves, k-means each half."""
    d = q.shape[-1]
    if d % 2:
        raise ValueError(f"PQ with B=2 needs even D, got {d}")
    q1, q2 = q[:, : d // 2], q[:, d // 2:]
    i1, i2 = (None, None) if init is None else init
    r1 = kmeans(gen, q1, k, iters, init=i1)
    r2 = kmeans(gen, q2, k, iters, init=i2)
    recon = torch.cat([r1.centroids[r1.assignments],
                       r2.centroids[r2.assignments]], dim=-1)
    return Quantization("pq", r1.centroids, r2.centroids,
                        r1.assignments, r2.assignments, q - recon)


def fit_rq(gen: torch.Generator, q: torch.Tensor, k: int, iters: int = 10,
           init: Optional[tuple] = None) -> Quantization:
    """Residual quantization: k-means on q, then k-means on the residuals."""
    i1, i2 = (None, None) if init is None else init
    r1 = kmeans(gen, q, k, iters, init=i1)
    resid1 = q - r1.centroids[r1.assignments]
    r2 = kmeans(gen, resid1, k, iters, init=i2)
    recon = r1.centroids[r1.assignments] + r2.centroids[r2.assignments]
    return Quantization("rq", r1.centroids, r2.centroids,
                        r1.assignments, r2.assignments, q - recon)


def fit(kind: str, gen: torch.Generator, q: torch.Tensor, k: int,
        iters: int = 10, init: Optional[tuple] = None) -> Quantization:
    if kind == "pq":
        return fit_pq(gen, q, k, iters, init)
    if kind == "rq":
        return fit_rq(gen, q, k, iters, init)
    raise ValueError(f"unknown quantizer kind {kind!r}")


def assign_against(kind: str, codebook1, codebook2, q):
    """Assign embeddings to *frozen* codebooks — one matmul per stage."""
    if kind == "pq":
        d = q.shape[-1]
        return _assign(q[:, : d // 2], codebook1), \
            _assign(q[:, d // 2:], codebook2)
    a1 = _assign(q, codebook1)
    return a1, _assign(q - codebook1[a1], codebook2)


def query_scores(kind: str, codebook1, codebook2, z):
    """Codeword scores s1, s2 for queries z [..., D] -> ([..., K], [..., K])."""
    if kind == "pq":
        d = z.shape[-1]
        return z[..., : d // 2] @ codebook1.T, z[..., d // 2:] @ codebook2.T
    return z @ codebook1.T, z @ codebook2.T
