"""Compatibility shim: the samplers live in `repro_torch.proposals`.

Mirrors `src/repro/core/samplers.py`: `Sampler` is an alias of
`Proposal` and `make_sampler` delegates to `make_proposal` with the
reference's knobs, so the benchmarks' `sampler_suite` builds its
contenders through it. New code imports from `repro_torch.proposals`,
whose registry also carries the contenders this shim predates (tapas,
rff-fused, the trainable midx-learnable-* codebooks).

SAMPLER_NAMES keeps the reference's value: the subset of PROPOSAL_NAMES the
original baseline suite covered (paper §6.1).
"""
from __future__ import annotations

from repro_torch.proposals import Draw, Proposal, make_proposal

__all__ = ["Draw", "Sampler", "make_sampler", "SAMPLER_NAMES"]

Sampler = Proposal


def make_sampler(name: str, *, k: int = 32, kmeans_iters: int = 10,
                 alpha: float = 100.0, rff_dim: int = 32, rff_tau: float = 4.0,
                 lsh_tables: int = 16, lsh_bits: int = 4) -> Sampler:
    """Factory. Names match the paper's §6.1 baselines."""
    return make_proposal(name, k=k, kmeans_iters=kmeans_iters, alpha=alpha,
                         rff_dim=rff_dim, rff_tau=rff_tau,
                         lsh_tables=lsh_tables, lsh_bits=lsh_bits)


SAMPLER_NAMES = ("uniform", "unigram", "full", "sphere", "rff", "lsh",
                 "midx-pq", "midx-rq", "midx-exact-rq")
