"""Re-export shim: the inverted multi-index lives in `repro_torch.index`.

Mirrors `src/repro/core/index.py`, which keeps the old import path
(`repro.core.index`, `from repro.core import build`) working after the
index moved to `repro.index` (DESIGN §8). New code imports from
`repro_torch.index`; the MIDX *proposal* built on this index lives in
`repro_torch.proposals.midx` behind the Proposal protocol (DESIGN §10).
"""
from repro_torch.index.build import (MultiIndex, _csr_from_assignments,
                                     build, from_quantization, reassign,
                                     refresh)

__all__ = ["MultiIndex", "build", "from_quantization", "reassign", "refresh",
           "_csr_from_assignments"]
