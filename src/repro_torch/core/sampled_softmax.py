"""Sampled softmax with corrected logits (paper §3.2, Eq. 1).

Mirrors `src/repro/core/sampled_softmax.py`: `NEG_INF` / `NEG_INF_THRESHOLD`
(:23-24), `corrected_logits` (:27), `sampled_softmax_loss` (:32) and
`full_softmax_loss` (:103). Given a positive logit o_pos and M negatives
s_j ~ Q with logits o_j:
    o'_pos = o_pos,   o'_j = o_j − ln(M · q_j)
    loss   = logsumexp([o'_pos, o'_1..o'_M]) − o_pos
Accidental hits (a negative equal to the positive) are masked to NEG_INF.
The partial/merge functions of the vocab-parallel head are not ported: the
single-device path does not use them.
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


def full_softmax_loss(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Full CE. logits [..., N], labels [...] -> [...]."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    pos = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - pos
