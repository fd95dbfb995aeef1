"""Sampled softmax with corrected logits (paper §3.2, Eq. 1).

Mirrors `src/repro/core/sampled_softmax.py`: `NEG_INF` / `NEG_INF_THRESHOLD`
(:23-24), `corrected_logits` (:27), `sampled_softmax_loss` (:32),
`partial_sampled_lse` (:53), `merge_sampled_softmax_loss` (:82),
`full_softmax_loss` (:103) and `sampled_softmax_from_embeddings` (:111). Given a positive logit o_pos and M negatives
s_j ~ Q with logits o_j:
    o'_pos = o_pos,   o'_j = o_j − ln(M · q_j)
    loss   = logsumexp([o'_pos, o'_1..o'_M]) − o_pos
Accidental hits (a negative equal to the positive) are masked to NEG_INF.
The vocab-parallel head (`dist.vocab_parallel`) splits the logsumexp over
shards: each takes the partial lse of the negatives it owns, and the merge
joins them with the positive; the shifts are detached, so the gradients
are the merged distribution's softmax weights.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

# Canonical collision-mask value, shared by the torch losses and the CUDA
# kernels (`kernels/sampled_ce/csrc`): large but finite, so exp(NEG_INF −
# lse) is exactly 0.0 in fp32 while online-logsumexp recurrences never see
# inf − inf. Masked-ness is tested as `x <= NEG_INF_THRESHOLD`.
NEG_INF = -1e30
NEG_INF_THRESHOLD = 0.5 * NEG_INF


def corrected_logits(neg_logits: torch.Tensor, log_q: torch.Tensor,
                     m: int) -> torch.Tensor:
    """o'_j = o_j − ln(M q_j)."""
    return neg_logits - (math.log(float(m)) + log_q)


def sampled_softmax_loss(pos_logit: torch.Tensor, neg_logits: torch.Tensor,
                         log_q: torch.Tensor,
                         neg_ids: Optional[torch.Tensor] = None,
                         pos_ids: Optional[torch.Tensor] = None,
                         mask_collisions: bool = True) -> torch.Tensor:
    """Per-example sampled softmax CE. pos_logit [...]; neg_logits/log_q
    [..., M]; neg_ids/pos_ids ([..., M] / [...]) for collision masking."""
    m = neg_logits.shape[-1]
    corr = corrected_logits(neg_logits.float(), log_q.float(), m)
    if mask_collisions and neg_ids is not None and pos_ids is not None:
        corr = torch.where(neg_ids == pos_ids[..., None],
                           corr.new_tensor(NEG_INF), corr)
    pos = pos_logit.float()[..., None]
    all_logits = torch.cat([pos, corr], dim=-1)
    return torch.logsumexp(all_logits, dim=-1) - pos[..., 0]


def partial_sampled_lse(neg_logits: torch.Tensor, log_q: torch.Tensor,
                        m: int, neg_ids: Optional[torch.Tensor] = None,
                        pos_ids: Optional[torch.Tensor] = None,
                        mask_collisions: bool = True,
                        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logsumexp over a subset of the corrected negatives. `m` is the global
    negative count (the ln M of the correction) while neg_logits/log_q
    [..., M'] hold one shard's slice; `valid` masks the entries the shard
    does not own. -> [...], NEG_INF (not −inf) where every entry is
    masked, so the merge counts the shard as zero mass."""
    corr = corrected_logits(neg_logits.float(), log_q.float(), m)
    if mask_collisions and neg_ids is not None and pos_ids is not None:
        corr = torch.where(neg_ids == pos_ids[..., None],
                           corr.new_tensor(NEG_INF), corr)
    if valid is not None:
        corr = torch.where(valid, corr, corr.new_tensor(NEG_INF))
    shift = torch.clamp(corr.max(dim=-1, keepdim=True).values.detach(),
                        min=NEG_INF)
    term = torch.where(corr > NEG_INF_THRESHOLD, torch.exp(corr - shift),
                       torch.zeros_like(corr))
    total = torch.sum(term, dim=-1)
    return torch.where(total > 0.0,
                       torch.log(torch.clamp(total, min=1e-30))
                       + shift[..., 0], total.new_tensor(NEG_INF))


def merge_sampled_softmax_loss(pos_logit: torch.Tensor,
                               partial_lses: torch.Tensor) -> torch.Tensor:
    """The loss from the positive logit [...] and the shards' partial lses
    [..., P] (NEG_INF marking an empty shard):
        s = max(pos, max_p lse_p),  l = e^{pos−s} + Σ_p e^{lse_p−s}
        loss = s + log l − pos
    equal to `sampled_softmax_loss` over the concatenated negatives up to
    reassociation; the shift s is detached."""
    pos = pos_logit.float()[..., None]
    allv = torch.cat([pos, partial_lses.float()], dim=-1)
    shift = allv.max(dim=-1, keepdim=True).values.detach()
    term = torch.where(allv > NEG_INF_THRESHOLD, torch.exp(allv - shift),
                       torch.zeros_like(allv))
    total = torch.sum(term, dim=-1)
    return (torch.log(torch.clamp(total, min=1e-30)) + shift[..., 0]
            - pos[..., 0])


def full_softmax_loss(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Full CE. logits [..., N], labels [...] -> [...]."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    pos = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - pos


def sampled_softmax_from_embeddings(hidden: torch.Tensor,
                                    class_emb: torch.Tensor,
                                    pos_ids: torch.Tensor,
                                    neg_ids: torch.Tensor,
                                    log_q: torch.Tensor,
                                    mask_collisions: bool = True
                                    ) -> torch.Tensor:
    """Convenience: gather embeddings, compute logits, then the loss.

    hidden: [..., D]; class_emb: [N, D]; pos_ids: [...];
    neg_ids/log_q: [..., M] (per-example) or [M] broadcast (shared
    negatives).
    """
    h = hidden.float()
    pos_ids = pos_ids.long()
    neg_ids = neg_ids.long()
    pos_e = class_emb[pos_ids].float()                           # [..., D]
    pos_logit = torch.sum(h * pos_e, dim=-1)
    if neg_ids.ndim == 1:                                        # shared
        neg_e = class_emb[neg_ids].float()                       # [M, D]
        neg_logits = h @ neg_e.T                                 # [..., M]
        log_q_b = torch.broadcast_to(log_q, neg_logits.shape)
        neg_ids_b = torch.broadcast_to(neg_ids, neg_logits.shape)
    else:
        neg_e = class_emb[neg_ids].float()                       # [..., M, D]
        neg_logits = torch.einsum("...d,...md->...m", h, neg_e)
        log_q_b, neg_ids_b = log_q, neg_ids
    return sampled_softmax_loss(pos_logit, neg_logits, log_q_b,
                                neg_ids_b, pos_ids, mask_collisions)
