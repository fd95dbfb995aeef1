"""Plain torch versions of the per-token sampled-CE kernels.

Mirrors `src/repro/kernels/sampled_ce/ref.py::sampled_ce_pt_ref` (:31): the
memory-hungry formulation the kernels replace — the [T, M, D] negative
gather and the [T, M] corrected logits are materialized here. The CPU path
runs these; `chip_smoke.py` holds the CUDA kernels against them on the
card. Autograd through `sampled_ce_pt_ref` is the plain backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.sampled_softmax import NEG_INF, corrected_logits


def _all_logits(hidden, table, log_q, neg_ids, pos_ids):
    # Rows are gathered with F.embedding: on the CPU its backward sums
    # duplicate ids in a fixed order, where `table[ids]`'s backward
    # (index_put_ with accumulate) uses atomics across threads.
    h = hidden.float()
    m = neg_ids.shape[-1]
    pos_logit = torch.sum(h * F.embedding(pos_ids, table).float(), dim=-1)
    neg_e = F.embedding(neg_ids, table).float()                      # [T,M,D]
    neg_logits = torch.einsum("td,tmd->tm", h, neg_e)
    corr = corrected_logits(neg_logits, log_q.float(), m)
    corr = torch.where(neg_ids == pos_ids[:, None],
                       corr.new_tensor(NEG_INF), corr)
    return pos_logit, torch.cat([pos_logit[:, None], corr], dim=-1)


def sampled_ce_pt_ref(hidden: torch.Tensor, table: torch.Tensor,
                      log_q: torch.Tensor, neg_ids: torch.Tensor,
                      pos_ids: torch.Tensor) -> torch.Tensor:
    """hidden [T, D]; table [V, D] (native dtype); log_q/neg_ids [T, M];
    pos_ids [T] -> per-token loss [T] fp32."""
    pos_logit, logits = _all_logits(hidden, table, log_q, neg_ids, pos_ids)
    return torch.logsumexp(logits, dim=-1) - pos_logit


def sampled_ce_pt_fwd_ref(hidden, table, log_q, neg_ids, pos_ids):
    """The forward kernel's outputs: (loss [T], lse [T]) fp32."""
    pos_logit, logits = _all_logits(hidden, table, log_q, neg_ids, pos_ids)
    lse = torch.logsumexp(logits, dim=-1)
    return lse - pos_logit, lse


def sampled_ce_pt_bwd_ref(g, hidden, table, log_q, neg_ids, pos_ids, lse):
    """The backward kernels' outputs, by autograd through the plain forward
    (which recomputes lse, so `lse` is unused): (dh [T, D], dtab [V, D],
    dlq [T, M]), all fp32. dtab is taken against an fp32 copy of the
    table, as the kernel accumulates it."""
    del lse
    with torch.enable_grad():
        h = hidden.detach().float().requires_grad_(True)
        lq = log_q.detach().float().requires_grad_(True)
        tab = table.detach().float().requires_grad_(True)
        loss = sampled_ce_pt_ref(h, tab, lq, neg_ids, pos_ids)
        dh, dtab, dlq = torch.autograd.grad(loss, (h, tab, lq), g.float())
    return dh, dtab, dlq
