"""Re-export shim: the quantizers live in `repro_torch.index.quantization`.

Mirrors `src/repro/core/quantization.py` (the old import path kept after
the move to `repro.index`, DESIGN §8). New code imports from
`repro_torch.index`, and from `repro_torch.proposals` for the samplers
built on these quantizers (DESIGN §10).
"""
from repro_torch.index.kmeans import _assign
from repro_torch.index.quantization import (Quantization, QuantizerKind,
                                            assign_against, assign_new, fit,
                                            fit_pq, fit_rq, query_scores,
                                            reconstruct)

__all__ = ["Quantization", "QuantizerKind", "assign_against", "assign_new",
           "fit", "fit_pq", "fit_rq", "query_scores", "reconstruct",
           "_assign"]
