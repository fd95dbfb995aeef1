"""repro_torch.proposals — the proposal-distribution subsystem.

Mirrors `src/repro/proposals/`: every sampled-softmax contender behind one
`Proposal` protocol, resolved by name through `registry`. Ported so far:
the RFF contenders `rff` and `rff-fused` (`rff.py`); the registry knows
the other names and raises NotImplementedError for them (ROADMAP.md
Queue 1 item 10).
"""
from repro_torch.proposals.base import (Draw, Proposal, categorical_draw,
                                        emb_refresh, no_refresh)
from repro_torch.proposals.registry import (PORTED_MODES, PROPOSAL_NAMES,
                                            from_config, make_proposal,
                                            proposal_modes, validate_mode)

__all__ = [
    "Draw", "Proposal", "categorical_draw", "emb_refresh", "no_refresh",
    "PORTED_MODES", "PROPOSAL_NAMES", "make_proposal", "from_config",
    "proposal_modes", "validate_mode",
]
