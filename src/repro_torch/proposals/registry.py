"""Proposal registry: one name -> Proposal for the whole stack.

Mirrors `src/repro/proposals/registry.py:25-160`: `PROPOSAL_NAMES`,
`make_proposal`, `from_config`, `validate_mode` and `proposal_modes`, with
the reference's names, modes and error texts. Train (`launch/steps.py`),
serve (`serve/engine.py`) and the lifecycle resolve contenders here.

Ported contenders: `rff` and `rff-fused`. Every other registered name is
known (it validates) but `make_proposal` raises NotImplementedError for it
(ROADMAP.md Queue 1 item 10); an unknown name raises the reference's
ValueError. `PORTED_MODES` are the head modes the port's CLIs offer.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.proposals import rff
from repro_torch.proposals.base import Proposal

__all__ = ["PROPOSAL_NAMES", "PORTED_MODES", "make_proposal", "from_config",
           "validate_mode", "proposal_modes"]

PROPOSAL_NAMES = (
    "uniform", "unigram", "full", "sphere", "rff", "rff-fused", "lsh",
    "tapas", "midx-pq", "midx-rq", "midx-exact-pq", "midx-exact-rq",
    "midx-learnable-pq", "midx-learnable-rq",
)

#: Head modes the port trains and serves: the dedicated lanes and the
#: ported registry contenders.
PORTED_MODES = ("midx", "full", "rff", "rff-fused")


def make_proposal(name: str, *, rff_dim: int = 32,
                  rff_tau: float = 4.0) -> Proposal:
    """Factory. Takes the knobs of the ported contenders only; the
    reference's others (k, alpha, tapas_pool, ...) come with theirs."""
    if name in ("rff", "rff-fused"):
        sample = rff.rff_sample if name == "rff" else rff.rff_fused_sample
        return Proposal(
            name,
            lambda gen, emb, freq=None: rff.rff_init(gen, emb, freq, rff_dim,
                                                     rff_tau),
            sample, rff.rff_log_prob, rff.rff_refresh, adaptive=True)
    if name in PROPOSAL_NAMES:
        raise NotImplementedError(
            f"proposal {name!r} is not ported to repro_torch yet (ROADMAP.md "
            f"Queue 1 item 10); ported: rff, rff-fused")
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
    return make_proposal(name, rff_dim=head_cfg.rff_dim,
                         rff_tau=head_cfg.rff_tau)
