"""repro_torch.proposals — the proposal-distribution subsystem.

Mirrors `src/repro/proposals/`: every sampled-softmax contender behind one
`Proposal` protocol, resolved by name through `registry`: the static
`uniform` / `unigram` / `full` (`static.py`), the `sphere` and `lsh`
baselines (`baselines.py`), `rff` / `rff-fused` (`rff.py`), `tapas`
(`tapas.py`), the MIDX contenders `midx-pq` / `-rq` and `midx-exact-*`
(`midx.py`) and the trainable `midx-learnable-*` (`learnable.py`).
"""
from repro_torch.proposals.base import (Draw, Proposal, categorical_draw,
                                        emb_refresh, no_refresh)
from repro_torch.proposals.registry import (PROPOSAL_NAMES, from_config,
                                            make_proposal, proposal_modes,
                                            validate_mode)

__all__ = [
    "Draw", "Proposal", "categorical_draw", "emb_refresh", "no_refresh",
    "PROPOSAL_NAMES", "make_proposal", "from_config", "proposal_modes",
    "validate_mode",
]
