"""Product / residual quantizers for the inverted multi-index (paper §4.1).

Mirrors `src/repro/index/quantization.py` (`QuantizerKind` :30,
`reconstruct` :51, `fit_pq` :60, `fit_rq` :77, `fit` :90, `assign_against`
:99, `assign_new` :113, `query_scores` :118). Both
quantizers give two codebooks of K codewords, assignments (k1, k2) per class
and residuals, and score a query z as
  PQ: z split into halves, s_l[k] = <z_l, c_l[k]>   (codewords in R^{D/2})
  RQ: full z against both,  s_l[k] = <z,  c_l[k]>   (codewords in R^D)
so that o_i = z·q_i = s1[k1(i)] + s2[k2(i)] + z·q~_i (Theorem 1).
Departures: the two K-means stages draw from one `torch.Generator` in turn
where the reference splits a JAX key; `keep_residuals=False` skips the
residual table that `index.build.build(keep_residuals=False)` would drop
anyway, and RQ's first-stage residuals are formed a block of rows at a
time, so a fit at V = 151 936, D = 5 120 holds one [N, D] table beside
the class table instead of up to four.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import torch

from repro_torch.index.kmeans import ROW_BLOCK, _assign, kmeans

QuantizerKind = Literal["pq", "rq"]


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


def _minus_gathered(q: torch.Tensor, centroids: torch.Tensor,
                    assign: torch.Tensor) -> torch.Tensor:
    """q - centroids[assign], a block of rows at a time: the same bits (an
    elementwise difference) without an [N, D] gather beside q and the
    result."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for i in range(0, q.shape[0], ROW_BLOCK):
        torch.sub(q[i:i + ROW_BLOCK], centroids[assign[i:i + ROW_BLOCK]],
                  out=out[i:i + ROW_BLOCK])
    return out


def _no_residuals(q: torch.Tensor) -> torch.Tensor:
    return q.new_zeros((0, q.shape[-1]))


def fit_pq(gen: torch.Generator, q: torch.Tensor, k: int, iters: int = 10,
           init: Optional[tuple] = None,
           keep_residuals: bool = True) -> Quantization:
    """Product quantization: split D into two halves, k-means each half.
    keep_residuals=False leaves the [N, D] residuals out ([0, D]) and so
    never builds the reconstruction; codebooks and assignments are the
    same bits."""
    d = q.shape[-1]
    if d % 2:
        raise ValueError(f"PQ with B=2 needs even D, got {d}")
    q1, q2 = q[:, : d // 2], q[:, d // 2:]
    i1, i2 = (None, None) if init is None else init
    r1 = kmeans(gen, q1, k, iters, init=i1)
    r2 = kmeans(gen, q2, k, iters, init=i2)
    if not keep_residuals:
        return Quantization("pq", r1.centroids, r2.centroids,
                            r1.assignments, r2.assignments, _no_residuals(q))
    recon = torch.cat([r1.centroids[r1.assignments],
                       r2.centroids[r2.assignments]], dim=-1)
    return Quantization("pq", r1.centroids, r2.centroids,
                        r1.assignments, r2.assignments, q - recon)


def fit_rq(gen: torch.Generator, q: torch.Tensor, k: int, iters: int = 10,
           init: Optional[tuple] = None,
           keep_residuals: bool = True) -> Quantization:
    """Residual quantization: k-means on q, then k-means on the residuals.
    keep_residuals as for `fit_pq`."""
    i1, i2 = (None, None) if init is None else init
    r1 = kmeans(gen, q, k, iters, init=i1)
    resid1 = _minus_gathered(q, r1.centroids, r1.assignments)
    r2 = kmeans(gen, resid1, k, iters, init=i2)
    if not keep_residuals:
        return Quantization("rq", r1.centroids, r2.centroids,
                            r1.assignments, r2.assignments, _no_residuals(q))
    del resid1
    recon = r1.centroids[r1.assignments] + r2.centroids[r2.assignments]
    return Quantization("rq", r1.centroids, r2.centroids,
                        r1.assignments, r2.assignments, q - recon)


def fit(kind: str, gen: torch.Generator, q: torch.Tensor, k: int,
        iters: int = 10, init: Optional[tuple] = None,
        keep_residuals: bool = True) -> Quantization:
    if kind == "pq":
        return fit_pq(gen, q, k, iters, init, keep_residuals)
    if kind == "rq":
        return fit_rq(gen, q, k, iters, init, keep_residuals)
    raise ValueError(f"unknown quantizer kind {kind!r}")


def assign_against(kind: str, codebook1, codebook2, q):
    """Assign embeddings to *frozen* codebooks — one matmul per stage."""
    if kind == "pq":
        d = q.shape[-1]
        return _assign(q[:, : d // 2], codebook1), \
            _assign(q[:, d // 2:], codebook2)
    a1 = _assign(q, codebook1)
    return a1, _assign(q - codebook1[a1], codebook2)


def assign_new(quant: Quantization, q) -> tuple:
    """Assign new class embeddings to existing codebooks (no re-fit)."""
    return assign_against(quant.kind, quant.codebook1, quant.codebook2, q)


def query_scores(kind: str, codebook1, codebook2, z):
    """Codeword scores s1, s2 for queries z [..., D] -> ([..., K], [..., K])."""
    if kind == "pq":
        d = z.shape[-1]
        return z[..., : d // 2] @ codebook1.T, z[..., d // 2:] @ codebook2.T
    return z @ codebook1.T, z @ codebook2.T
