"""MIDX sampler core and counter-based noise (mirrors `src/repro/core/`).

The same names as the reference's package: K-means, the quantizers and
the index through the re-export shims over `repro_torch.index`, the alias
tables, `midx`, the sampled-softmax losses and the learnable codebooks;
`make_sampler`, `Sampler` and `SAMPLER_NAMES` on first use.
"""
from repro_torch.core.kmeans import kmeans, KMeansResult
from repro_torch.core.quantization import (fit, fit_pq, fit_rq, Quantization,
                                           query_scores)
from repro_torch.core.index import MultiIndex, build, refresh
from repro_torch.core.alias import AliasTable, build_alias, sample_alias
from repro_torch.core import midx
from repro_torch.core.midx import Draw
from repro_torch.core.sampled_softmax import (
    sampled_softmax_loss, full_softmax_loss, sampled_softmax_from_embeddings,
    corrected_logits)
from repro_torch.core.learnable import (
    LearnableCodebooks, init_learnable, codebook_losses, index_from_learnable)


def __getattr__(name):
    # Lazy (PEP 562), as in the reference: core.samplers is a shim over
    # repro_torch.proposals, which itself imports core.midx — loading it
    # here would close an import cycle when proposals is the entry point.
    if name in ("make_sampler", "Sampler", "SAMPLER_NAMES"):
        from repro_torch.core import samplers
        return getattr(samplers, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
