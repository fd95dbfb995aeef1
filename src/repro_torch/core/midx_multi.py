"""B > 2 codebook MIDX (paper §4.1 / §4.2: "straightforwardly extended").

Mirrors `src/repro/core/midx_multi.py:30-113`. Residual quantization with
B levels: codebooks C^1..C^B, assignments k_1(i)..k_B(i), residual
q̃_i = q_i − Σ_l c^l_{k_l(i)}. The fast proposal keeps the uniform final
stage:

    Q(i|z) ∝ exp(Σ_l s_l[k_l(i)])        s_l = z · C^lᵀ

computed per class (O(N·B) adds, no N·D dot products); for B = 2 prefer
`core.midx` (O(K²)).

Departures: `build_b` runs the port's `index.kmeans` with one
`torch.Generator` stream a level (a base seed drawn once from `gen`, level
l's stream seeded by hash(seed, l)), where the reference folds l into a JAX
key; `sample` is the flat per-class categorical through the generic
proposals' Gumbel-max draw (`categorical_draw`, which `proposals.base`
re-exports), keyed per row.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import noise
from repro_torch.core.midx import Draw, categorical_draw
from repro_torch.index.kmeans import kmeans


@dataclasses.dataclass(frozen=True)
class MultiIndexB:
    codebooks: tuple             # B × [K, D]
    assigns: tuple               # B × [N] int64
    residuals: torch.Tensor      # [N, D]

    @property
    def num_books(self) -> int:
        return len(self.codebooks)

    @property
    def num_codewords(self) -> int:
        return self.codebooks[0].shape[0]

    @property
    def num_classes(self) -> int:
        return self.assigns[0].shape[0]


#: The data fields, in the reference's flatten order.
MULTI_FIELDS = ("codebooks", "assigns", "residuals")


def build_b(gen: torch.Generator, class_emb: torch.Tensor, *, b: int = 4,
            k: int = 16, iters: int = 8) -> MultiIndexB:
    """B-level residual quantization index."""
    dev = class_emb.device
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen,
                             device=gen.device))
    resid = class_emb.float()
    books, assigns = [], []
    for level in range(b):
        g = torch.Generator(device=dev)
        g.manual_seed(int(noise.hash_bits(seed, level, 0, 0)))
        res = kmeans(g, resid, k, iters)
        books.append(res.centroids)
        assigns.append(res.assignments)
        resid = resid - res.centroids[res.assignments]
    return MultiIndexB(tuple(books), tuple(assigns), resid)


def scores(index: MultiIndexB, z: torch.Tensor) -> torch.Tensor:
    """Stacked codeword scores: [B, ..., K]."""
    zf = z.float()
    return torch.stack([zf @ cb.T for cb in index.codebooks], dim=0)


def _per_class(index: MultiIndexB, z: torch.Tensor) -> torch.Tensor:
    """Σ_l s_l[k_l(i)] for every class: [..., N]."""
    s = scores(index, z)
    return sum(s[level].index_select(-1, index.assigns[level])
               for level in range(index.num_books))


def log_prob(index: MultiIndexB, z: torch.Tensor,
             ids: torch.Tensor) -> torch.Tensor:
    """log Q(ids|z), closed form: Σ_l s_l[k_l(i)] − lse over all classes."""
    per_class = _per_class(index, z)
    lse = torch.logsumexp(per_class, dim=-1, keepdim=True)
    return torch.gather(per_class, -1, ids) - lse


def sample(index: MultiIndexB, keys: torch.Tensor, z: torch.Tensor,
           m: int) -> Draw:
    """Draw m classes per query row (keys [...] one per row of z [..., D])
    from the flat per-class form of the B-stage chain."""
    per_class = _per_class(index, z)
    lse = torch.logsumexp(per_class, dim=-1, keepdim=True)
    return categorical_draw(keys, per_class - lse, m)


def kl_to_softmax(index: MultiIndexB, z: torch.Tensor,
                  class_emb: torch.Tensor) -> torch.Tensor:
    """KL(Q_B ‖ P) per query: the Theorem-5 analogue for B books."""
    log_p = torch.log_softmax(z.float() @ class_emb.float().T, dim=-1)
    n = index.num_classes
    lq = log_prob(index, z, torch.arange(n, device=z.device).expand(
        *z.shape[:-1], n))
    return torch.sum(torch.exp(lq) * (lq - log_p), dim=-1)
