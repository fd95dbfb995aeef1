"""Plain torch versions of the sampled-CE kernels: per-token and shared.

Mirrors `src/repro/kernels/sampled_ce/ref.py::sampled_ce_pt_ref` (:31): the
memory-hungry formulation the kernels replace — the [T, M, D] negative
gather and the [T, M] corrected logits are materialized here. The CPU path
runs these; `chip_smoke.py` holds the CUDA kernels against them on the
card. Autograd through `sampled_ce_pt_ref` is the plain backward.

The quantized mode (reference `per_token.py:99-111`, `:255-262`, and
`sampled_ce.py:49-50`, `:190-270`): `scale` [V, 1] fp32 makes `table` the
int8 / fp8 copy, a gathered row is dequantized as `rows · s` before the
dot, and the backward's d(table) is scale-unaware, the gradient with
respect to the dequantized rows, which the straight-through estimator
hands to the master table. The shared-negative twins take the gathered
rows' scales, [B, S, 1] and [B, M, 1].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.sampled_softmax import (NEG_INF, NEG_INF_THRESHOLD,
                                              corrected_logits)


def _rows(table, ids, scale):
    """fp32 rows table[ids], dequantized (· scale[ids]) where scale is
    given. Rows are gathered with F.embedding: on the CPU its backward sums
    duplicate ids in a fixed order, where `table[ids]`'s backward
    (index_put_ with accumulate) uses atomics across threads. A low-bit
    table is data, never differentiated: it is indexed."""
    if scale is None:
        return F.embedding(ids, table).float()
    return table[ids].float() * scale.float().reshape(-1, 1)[ids]


def _all_logits(hidden, table, log_q, neg_ids, pos_ids, scale=None):
    h = hidden.float()
    m = neg_ids.shape[-1]
    pos_logit = torch.sum(h * _rows(table, pos_ids, scale), dim=-1)
    neg_e = _rows(table, neg_ids, scale)                             # [T,M,D]
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


def sampled_ce_pt_fwd_ref(hidden, table, log_q, neg_ids, pos_ids,
                          scale=None):
    """The forward kernel's outputs: (loss [T], lse [T]) fp32; `scale`
    [V, 1] given: the quantized mode."""
    pos_logit, logits = _all_logits(hidden, table, log_q, neg_ids, pos_ids,
                                    scale)
    lse = torch.logsumexp(logits, dim=-1)
    return lse - pos_logit, lse


def sampled_ce_pt_fold(hidden, table, log_q, neg_ids, pos_ids,
                       group: int = 8):
    """The forward kernels' order of the logsumexp, stated plainly
    (`csrc/sampled_ce_pt.cu::fold_group`, `finish_lse`): an online (m, l)
    over groups of `group` corrected logits in ascending j — m the running
    max, each group's exponentials summed in ascending j, l rescaled by
    exp(m_old − m_new) — then the positive folded last. A masked column
    (a collision) adds 0; a token whose every column is masked gets
    lse = pos. -> (loss [T], lse [T]) fp32."""
    pos, logits = _all_logits(hidden, table, log_q, neg_ids, pos_ids)
    corr = logits[:, 1:]
    m = torch.full_like(pos, NEG_INF)
    l = torch.zeros_like(pos)
    zero = torch.zeros_like(pos)
    for j0 in range(0, corr.shape[1], group):
        c = corr[:, j0:j0 + group]
        m_new = torch.maximum(m, c.max(dim=1).values)
        s = zero
        for k in range(c.shape[1]):
            s = s + torch.where(c[:, k] > NEG_INF_THRESHOLD,
                                torch.exp(c[:, k] - m_new), zero)
        l = l * torch.exp(m - m_new) + s
        m = m_new
    m_fin = torch.maximum(m, pos)
    l_fin = l * torch.exp(m - m_fin) + torch.exp(pos - m_fin)
    lse = torch.log(torch.clamp(l_fin, min=1e-30)) + m_fin
    return lse - pos, lse


def sampled_ce_pt_bwd_ref(g, hidden, table, log_q, neg_ids, pos_ids, lse,
                          scale=None):
    """The backward kernels' outputs, by autograd through the plain forward
    (which recomputes lse, so `lse` is unused): (dh [T, D], dtab [V, D],
    dlq [T, M]), all fp32. dtab is taken against an fp32 copy of the
    table, as the kernel accumulates it; in the quantized mode against the
    dequantized table, so it is scale-unaware."""
    del lse
    with torch.enable_grad():
        h = hidden.detach().float().requires_grad_(True)
        lq = log_q.detach().float().requires_grad_(True)
        tab = table.detach().float() if scale is None else \
            table.detach().float() * scale.detach().float().reshape(-1, 1)
        tab.requires_grad_(True)
        loss = sampled_ce_pt_ref(h, tab, lq, neg_ids, pos_ids)
        dh, dtab, dlq = torch.autograd.grad(loss, (h, tab, lq), g.float())
    return dh, dtab, dlq


# ------------------------------------------------------ shared negatives
# Mirrors `src/repro/kernels/sampled_ce/ref.py::sampled_ce_ref` (:15) with
# the batch as a leading dimension: each sequence b scores its S tokens
# against its own M shared negatives. hidden/pos_emb [B, S, D]; neg_emb
# [B, M, D]; log_q/neg_ids [B, M]; pos_ids [B, S].

def _shared_corr(hidden, neg_emb, log_q, neg_ids, pos_ids):
    """Corrected, collision-masked negative logits [B, S, M] (fp32)."""
    m = neg_emb.shape[-2]
    logits = torch.matmul(hidden.float(), neg_emb.float().transpose(-1, -2))
    corr = corrected_logits(logits, log_q.float()[:, None, :], m)
    hit = neg_ids[:, None, :] == pos_ids[:, :, None]
    return torch.where(hit, corr.new_tensor(NEG_INF), corr)


def _dequant(rows, scale):
    """Gathered low-bit rows times their [..., 1] scales (fp32); rows as
    they are where no scale is given."""
    return rows if scale is None else rows.float() * scale.float()


def sampled_ce_fwd_ref(hidden, pos_emb, neg_emb, log_q, neg_ids, pos_ids,
                       pos_scale=None, neg_scale=None):
    """The forward kernel's outputs: (loss [B, S], lse [B, S]) fp32.
    pos_scale [B, S, 1] / neg_scale [B, M, 1] given: the quantized mode,
    pos_emb / neg_emb gathered int8 / fp8 rows."""
    pos_emb = _dequant(pos_emb, pos_scale)
    neg_emb = _dequant(neg_emb, neg_scale)
    pos_logit = torch.sum(hidden.float() * pos_emb.float(), dim=-1)
    corr = _shared_corr(hidden, neg_emb, log_q, neg_ids, pos_ids)
    lse = torch.logsumexp(torch.cat([pos_logit[..., None], corr], dim=-1),
                          dim=-1)
    return lse - pos_logit, lse


def sampled_ce_ref(hidden, pos_emb, neg_emb, log_q, neg_ids, pos_ids):
    """Per-token corrected sampled-softmax CE [B, S] fp32 (Eq. 1 with
    collision masking); autograd through it is the plain backward."""
    return sampled_ce_fwd_ref(hidden, pos_emb, neg_emb, log_q, neg_ids,
                              pos_ids)[0]


def sampled_ce_bwd_ref(g, hidden, pos_emb, neg_emb, log_q, neg_ids, pos_ids,
                       lse, pos_scale=None, neg_scale=None):
    """The backward kernels' outputs from the saved lse, as
    `sampled_ce.py::sampled_ce_bwd` (:277-372) computes them:
      w   = exp(corr − lse) on valid entries, else 0     [B, S, M]
      dh  = g·(w @ ne + (p_pos − 1)·pe),  dpe = g·(p_pos − 1)·h
      dne = (g·w)ᵀ @ h,                   dlq = −Σ_s g·w
    -> (dh, dpe [B, S, D], dne [B, M, D], dlq [B, M]), all fp32. In the
    quantized mode pe and ne are the dequantized rows, and dpe / dne stay
    scale-unaware (the master rows' straight-through gradients)."""
    pos_emb = _dequant(pos_emb, pos_scale)
    neg_emb = _dequant(neg_emb, neg_scale)
    h, pe, ne = hidden.float(), pos_emb.float(), neg_emb.float()
    g = g.float()[..., None]                                     # [B,S,1]
    lse = lse[..., None]
    corr = _shared_corr(hidden, neg_emb, log_q, neg_ids, pos_ids)
    w = torch.where(corr > NEG_INF_THRESHOLD, torch.exp(corr - lse),
                    torch.zeros_like(corr))
    p_pos = torch.exp(torch.sum(h * pe, dim=-1, keepdim=True) - lse)
    dh = g * (torch.matmul(w, ne) + (p_pos - 1.0) * pe)
    dpe = g * (p_pos - 1.0) * h
    gw = g * w
    return (dh, dpe, torch.matmul(gw.transpose(-1, -2), h),
            -torch.sum(gw, dim=-2))


# ------------------------------------------------------------ partial mode
# The vocab-parallel head's shard of the loss, the TPU kernels'
# `include_pos=False` (reference `per_token.py:125-132`, `:246-249`,
# `sampled_ce.py:70-77`, `:229-231`): the negatives are one shard's (a
# negative it does not own comes clipped to local row 0 with lq = +1e30,
# so its corrected logit is NEG_INF), the positive id is local on its
# owner and -1 elsewhere and only masks collisions, ln M uses the global
# negative count `num_neg`, and the result is the negatives-only lse.

def partial_lse(corr: torch.Tensor) -> torch.Tensor:
    """The kernels' partial lse of corrected logits [..., M]: m the max of
    every column (a masked one is ~NEG_INF), the valid columns'
    exp(corr − m) summed into l, then log(max(l, 1e-30)) + m; NEG_INF
    where no column is valid. m is detached: the gradient is exp(corr −
    lse) on the valid columns, 0 elsewhere and on an all-masked row."""
    m = torch.clamp(corr.max(dim=-1, keepdim=True).values.detach(),
                    min=NEG_INF)
    term = torch.where(corr > NEG_INF_THRESHOLD, torch.exp(corr - m),
                       torch.zeros_like(corr))
    return torch.log(torch.clamp(term.sum(-1), min=1e-30)) + m[..., 0]


def sampled_ce_pt_partial_ref(hidden, table, log_q, neg_ids, pos_ids,
                              num_neg: int, scale=None) -> torch.Tensor:
    """Per-token partial lse [T] fp32: hidden [T, D]; table [V, D] a
    shard's rows (int8 / fp8 with `scale` [V, 1]); log_q/neg_ids [T, M]
    (local rows); pos_ids [T] local or -1. Autograd through it is the
    plain backward."""
    neg_e = _rows(table, neg_ids, scale)                            # [T,M,D]
    corr = corrected_logits(torch.einsum("td,tmd->tm", hidden.float(),
                                         neg_e), log_q.float(), num_neg)
    corr = torch.where(neg_ids == pos_ids[:, None], corr.new_tensor(NEG_INF),
                       corr)
    return partial_lse(corr)


def sampled_ce_pt_partial_bwd_ref(g, hidden, table, log_q, neg_ids, pos_ids,
                                  lse, num_neg: int, scale=None):
    """The partial backward kernel's outputs, by autograd through the plain
    partial forward (`lse` unused): (dh [T, D], dtab [V, D], dlq [T, M])
    fp32; dtab scale-unaware in the quantized mode, as in the full mode."""
    del lse
    with torch.enable_grad():
        h = hidden.detach().float().requires_grad_(True)
        lq = log_q.detach().float().requires_grad_(True)
        tab = table.detach().float() if scale is None else \
            table.detach().float() * scale.detach().float().reshape(-1, 1)
        tab.requires_grad_(True)
        out = sampled_ce_pt_partial_ref(h, tab, lq, neg_ids, pos_ids,
                                        num_neg)
        return torch.autograd.grad(out, (h, tab, lq), g.float())


def _shared_partial_corr(hidden, neg_emb, log_q, neg_ids, pos_ids, num_neg,
                         neg_scale):
    neg_emb = _dequant(neg_emb, neg_scale)
    logits = torch.matmul(hidden.float(), neg_emb.float().transpose(-1, -2))
    corr = corrected_logits(logits, log_q.float()[:, None, :], num_neg)
    hit = neg_ids[:, None, :] == pos_ids[:, :, None]
    return torch.where(hit, corr.new_tensor(NEG_INF), corr), neg_emb


def sampled_ce_partial_fwd_ref(hidden, neg_emb, log_q, neg_ids, pos_ids,
                               num_neg: int, neg_scale=None) -> torch.Tensor:
    """Shared-negative partial lse [B, S] fp32: hidden [B, S, D]; neg_emb
    [B, M, D] a shard's gathered rows (int8 / fp8 with neg_scale
    [B, M, 1]); log_q/neg_ids [B, M]; pos_ids [B, S] local or -1."""
    corr, _ = _shared_partial_corr(hidden, neg_emb, log_q, neg_ids, pos_ids,
                                   num_neg, neg_scale)
    return partial_lse(corr)


def sampled_ce_partial_bwd_ref(g, hidden, neg_emb, log_q, neg_ids, pos_ids,
                               lse, num_neg: int, neg_scale=None):
    """The partial backward kernels' outputs from the saved partial lse,
    as `sampled_ce.py::sampled_ce_bwd` (:323-372) computes them with
    include_pos=False: w = exp(corr − lse) on valid entries, else 0;
    dh = g·(w @ ne), dne = (g·w)ᵀ @ h (scale-unaware), dlq = −Σ_s g·w.
    -> (dh [B, S, D], dne [B, M, D], dlq [B, M]), fp32."""
    corr, ne = _shared_partial_corr(hidden, neg_emb, log_q, neg_ids, pos_ids,
                                    num_neg, neg_scale)
    w = torch.where(corr > NEG_INF_THRESHOLD, torch.exp(corr - lse[..., None]),
                    torch.zeros_like(corr))
    gw = g.float()[..., None] * w
    return (torch.matmul(gw, ne.float()),
            torch.matmul(gw.transpose(-1, -2), hidden.float()),
            -torch.sum(gw, dim=-2))
