"""Inverted multi-index with a CSR cluster layout.

Mirrors `src/repro/index/build.py` (`MultiIndex` :36,
`_csr_from_assignments` :65, `from_quantization` :78, `build` :99,
`reassign` :131, `refresh` :139). The
ragged cluster sets Ω(k1,k2) are stored flat:
  sorted_ids[N]   class ids sorted by joint cluster c = k1 * K + k2
  offsets[K²+1]   start offset of each joint cluster in sorted_ids
  counts[K, K]    |Ω(k1,k2)|
so a uniform draw from Ω(c) is sorted_ids[offsets[c] + r], r < counts[c].
Departures: `MultiIndex` is a frozen dataclass of tensors; index fields are
int64 (torch's indexing type) where the reference keeps int32; `build`
takes a `torch.Generator`. The sort by joint cluster is stable, as
`jnp.argsort` is, so both packages order the members of a cluster alike.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.index.quantization import (Quantization, assign_against,
                                           fit, reconstruct)


@dataclasses.dataclass(frozen=True)
class MultiIndex:
    kind: str                    # 'pq' | 'rq'
    codebook1: torch.Tensor      # [K, D or D/2] fp32
    codebook2: torch.Tensor      # [K, D or D/2] fp32
    assign1: torch.Tensor        # [N] int64
    assign2: torch.Tensor        # [N] int64
    residuals: torch.Tensor      # [N, D] (only the exact sampler needs it)
    sorted_ids: torch.Tensor     # [N] int64
    offsets: torch.Tensor        # [K²+1] int64
    counts: torch.Tensor         # [K, K] int64 == |Ω|
    log_counts: torch.Tensor     # [K, K] fp32: log|Ω|, -inf for empty

    @property
    def num_codewords(self) -> int:
        return self.codebook1.shape[0]

    @property
    def num_classes(self) -> int:
        return self.sorted_ids.shape[0]

    @property
    def has_residuals(self) -> bool:
        return self.residuals.shape[0] > 0

    def joint_cluster(self) -> torch.Tensor:
        """Joint cluster id per class: k1 * K + k2. [N]"""
        return self.assign1 * self.num_codewords + self.assign2


def _csr_from_assignments(assign1: torch.Tensor, assign2: torch.Tensor,
                          k: int):
    joint = assign1.long() * k + assign2.long()                     # [N]
    sorted_ids = torch.sort(joint, stable=True).indices
    if joint.is_meta:       # the dry run's plan: shapes only
        counts_flat = joint.new_empty((k * k,))
    else:
        counts_flat = torch.bincount(joint, minlength=k * k)
    offsets = torch.cat([counts_flat.new_zeros(1),
                         torch.cumsum(counts_flat, 0)])
    counts = counts_flat.reshape(k, k)
    log_counts = torch.where(counts > 0,
                             torch.log(torch.clamp(counts, min=1).float()),
                             torch.full_like(counts, float("-inf"),
                                             dtype=torch.float32))
    return sorted_ids, offsets, counts, log_counts


def from_quantization(quant: Quantization) -> MultiIndex:
    sorted_ids, offsets, counts, log_counts = _csr_from_assignments(
        quant.assign1, quant.assign2, quant.num_codewords)
    return MultiIndex(quant.kind, quant.codebook1, quant.codebook2,
                      quant.assign1, quant.assign2, quant.residuals,
                      sorted_ids, offsets, counts, log_counts)


def build(gen: torch.Generator, class_embeddings: torch.Tensor, *,
          kind: str = "rq", k: int = 32, iters: int = 10,
          keep_residuals: bool = True,
          init: Optional[tuple] = None) -> MultiIndex:
    """Fit the quantizer and build the CSR layout.

    keep_residuals=False drops the [N, D] residual table (only the exact
    sampler needs it). init: optional (codebook1, codebook2) warm start for
    both K-means stages.
    """
    return from_quantization(fit(kind, gen, class_embeddings, k, iters, init,
                                 keep_residuals))


def reassign(index: MultiIndex, class_embeddings: torch.Tensor) -> MultiIndex:
    """Incremental refresh: keep the codebooks, recompute the assignments
    against the updated class table (one matmul per stage) and rebuild the
    CSR layout. No Lloyd iterations."""
    a1, a2 = assign_against(index.kind, index.codebook1, index.codebook2,
                            class_embeddings)
    sorted_ids, offsets, counts, log_counts = _csr_from_assignments(
        a1, a2, index.num_codewords)
    residuals = index.residuals
    if index.has_residuals:
        residuals = class_embeddings - reconstruct(
            index.kind, index.codebook1, index.codebook2, a1, a2)
    return MultiIndex(index.kind, index.codebook1, index.codebook2, a1, a2,
                      residuals, sorted_ids, offsets, counts, log_counts)


def refresh(index: MultiIndex, gen: torch.Generator,
            class_embeddings: torch.Tensor, *,
            iters: int = 10) -> MultiIndex:
    """Full refit against updated class embeddings (the paper's per-epoch
    rebuild), both K-means stages warm-started from the current codebooks.
    The reference's `warm=False` cold rebuild is `build` itself."""
    return build(gen, class_embeddings, kind=index.kind,
                 k=index.num_codewords, iters=iters,
                 keep_residuals=index.has_residuals,
                 init=(index.codebook1, index.codebook2))
