"""Proposal registry: one name -> Proposal for the whole stack.

Mirrors `src/repro/proposals/registry.py:25-160`: `PROPOSAL_NAMES`,
`make_proposal` (every one of the 14 names, with the reference's knobs),
`from_config` (the knobs from a HeadConfig, as at :139-160),
`validate_mode` and `proposal_modes`, with the reference's names, modes
and error texts. Train (`launch/steps.py`), serve (`serve/engine.py`) and
the lifecycle resolve contenders here.

Names (PROPOSAL_NAMES):
  static    uniform, unigram
  adaptive  full, sphere, rff, rff-fused, lsh, tapas,
            midx-pq, midx-rq, midx-exact-pq, midx-exact-rq
  trainable midx-learnable-pq, midx-learnable-rq

Departure: the reference's `use_kernel` / `interpret` knobs (the fused RFF
sampler's backend) are absent: the tensor's device picks the kernel or its
plain version (`kernels.dispatch`).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.proposals import (baselines, learnable, midx, rff, static,
                                   tapas)
from repro_torch.proposals.base import Proposal, emb_refresh, no_refresh

__all__ = ["PROPOSAL_NAMES", "make_proposal", "from_config",
           "validate_mode", "proposal_modes"]

PROPOSAL_NAMES = (
    "uniform", "unigram", "full", "sphere", "rff", "rff-fused", "lsh",
    "tapas", "midx-pq", "midx-rq", "midx-exact-pq", "midx-exact-rq",
    "midx-learnable-pq", "midx-learnable-rq",
)


def make_proposal(name: str, *, k: int = 32, kmeans_iters: int = 10,
                  alpha: float = 100.0, rff_dim: int = 32,
                  rff_tau: float = 4.0, lsh_tables: int = 16,
                  lsh_bits: int = 4, tapas_pool: int = 256,
                  tapas_eps: float = 0.05, aux_recon_weight: float = 1.0,
                  aux_kl_weight: float = 1.0) -> Proposal:
    """Factory. Knobs a name does not use are ignored, so callers can
    forward one config-derived kwargs dict for every contender."""
    if name == "uniform":
        return Proposal(name, static.uniform_init, static.uniform_sample,
                        static.uniform_log_prob, no_refresh)
    if name == "unigram":
        return Proposal(name, static.unigram_init, static.unigram_sample,
                        static.unigram_log_prob, no_refresh)
    if name == "full":
        return Proposal(name, static.full_init, static.full_sample,
                        static.full_log_prob, emb_refresh, adaptive=True)
    if name == "sphere":
        return Proposal(
            name,
            lambda gen, emb, freq=None: baselines.sphere_init(
                gen, emb, freq, alpha),
            baselines.sphere_sample, baselines.sphere_log_prob, emb_refresh,
            adaptive=True)
    if name in ("rff", "rff-fused"):
        sample = rff.rff_sample if name == "rff" else rff.rff_fused_sample
        return Proposal(
            name,
            lambda gen, emb, freq=None: rff.rff_init(gen, emb, freq, rff_dim,
                                                     rff_tau),
            sample, rff.rff_log_prob, rff.rff_refresh, adaptive=True)
    if name == "lsh":
        return Proposal(
            name,
            lambda gen, emb, freq=None: baselines.lsh_init(
                gen, emb, freq, lsh_tables, lsh_bits),
            baselines.lsh_sample, baselines.lsh_log_prob,
            baselines.lsh_refresh, adaptive=True)
    if name == "tapas":
        return Proposal(name, tapas.tapas_init_factory(tapas_pool, tapas_eps),
                        tapas.tapas_sample, tapas.tapas_log_prob,
                        tapas.tapas_refresh, adaptive=True)
    if name in ("midx-pq", "midx-rq"):
        kind = name.split("-")[1]
        return Proposal(name, midx.midx_init_factory(kind, k, kmeans_iters),
                        midx.midx_sample, midx.midx_log_prob,
                        midx.midx_refresh, adaptive=True)
    if name in ("midx-exact-pq", "midx-exact-rq"):
        kind = name.split("-")[2]
        return Proposal(name,
                        midx.midx_exact_init_factory(kind, k, kmeans_iters),
                        midx.midx_exact_sample, midx.midx_exact_log_prob,
                        midx.midx_exact_refresh, adaptive=True)
    if name in ("midx-learnable-pq", "midx-learnable-rq"):
        kind = name.split("-")[2]
        return Proposal(
            name, learnable.learnable_init_factory(kind, k, kmeans_iters),
            learnable.learnable_sample, learnable.learnable_log_prob,
            learnable.learnable_refresh, adaptive=True, trainable=True,
            aux_loss=learnable.learnable_aux_factory(aux_recon_weight,
                                                     aux_kl_weight),
            split_trainable=learnable.learnable_split,
            merge_trainable=learnable.learnable_merge)
    raise ValueError(
        f"unknown proposal {name!r}; known: {', '.join(PROPOSAL_NAMES)}")


# head modes the train/serve stacks accept; "midx" and "full" keep their
# dedicated lanes in models/heads.py, everything else routes through the
# generic loss_sampled path.
_MODE_TO_NAME = {
    "uniform": "uniform",
    "unigram": "unigram",
    "sphere": "sphere",
    "rff": "rff",
    "rff-fused": "rff-fused",
    "lsh": "lsh",
    "tapas": "tapas",
    "midx-learnable": None,   # resolved with the quantizer kind below
}


def proposal_modes() -> tuple:
    """Every valid HeadConfig.mode (dedicated lanes + registry names)."""
    return ("midx", "full", *_MODE_TO_NAME.keys())


def validate_mode(mode: str) -> None:
    if mode not in proposal_modes():
        raise ValueError(
            f"unknown head mode {mode!r}; valid modes: "
            f"{', '.join(proposal_modes())}. 'midx' and 'full' use the "
            "dedicated heads, the rest resolve to repro.proposals "
            "contenders.")


def from_config(head_cfg, mode: Optional[str] = None) -> Proposal:
    """Resolve a HeadConfig (+ optional mode override) to its Proposal."""
    mode = mode or head_cfg.mode
    validate_mode(mode)
    if mode == "midx":
        name = f"midx-{head_cfg.quantizer}"
    elif mode == "midx-learnable":
        name = f"midx-learnable-{head_cfg.quantizer}"
    elif mode == "full":
        name = "full"
    else:
        name = _MODE_TO_NAME[mode]
    return make_proposal(
        name,
        k=head_cfg.midx_k,
        kmeans_iters=head_cfg.kmeans_iters,
        alpha=getattr(head_cfg, "sphere_alpha", 100.0),
        rff_dim=getattr(head_cfg, "rff_dim", 32),
        rff_tau=getattr(head_cfg, "rff_tau", 4.0),
        tapas_pool=getattr(head_cfg, "tapas_pool", 256),
        tapas_eps=getattr(head_cfg, "tapas_eps", 0.05),
        aux_recon_weight=getattr(head_cfg, "aux_recon_weight", 1.0),
        aux_kl_weight=getattr(head_cfg, "aux_kl_weight", 1.0),
    )
