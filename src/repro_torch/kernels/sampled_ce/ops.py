"""Public wrappers: the sampled-softmax CE, differentiable.

Mirrors `src/repro/kernels/sampled_ce/ops.py`: `sampled_ce_op` (:26-49,
the custom VJP `_fwd` / `_bwd`, shared negatives, with the batch as a
leading dimension where the reference vmaps) and `sampled_ce_pt_op`
(:52-80, `_pt_fwd` / `_pt_bwd`, per-token negatives). Each forward goes
through `kernels.dispatch` and saves its lse; each backward goes through
the matching backward in `kernels.dispatch` — the CUDA kernels for CUDA
tensors, the plain versions for CPU tensors. Unlike the reference there is
no `interpret` / `block_t` / `chunk` argument: the device decides, and the
kernels need no block sizes from the caller.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch


class SampledCEPerTokenFn(torch.autograd.Function):
    """(hidden [T,D], table [V,D], log_q [T,M], neg_ids, pos_ids) -> loss
    [T]. Gradients: hidden, table (in the table's dtype) and log_q."""

    @staticmethod
    def forward(ctx, hidden, table, log_q, neg_ids, pos_ids):
        loss, lse = dispatch.sampled_ce_pt(hidden, table, log_q, neg_ids,
                                           pos_ids)
        ctx.save_for_backward(hidden, table, log_q, neg_ids, pos_ids, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, table, log_q, neg_ids, pos_ids, lse = ctx.saved_tensors
        dh, dtab, dlq = dispatch.sampled_ce_pt_bwd(
            g.float().contiguous(), hidden, table, log_q, neg_ids, pos_ids,
            lse)
        return (dh.to(hidden.dtype), dtab.to(table.dtype),
                dlq.to(log_q.dtype), None, None)


def sampled_ce_pt_op(hidden: torch.Tensor, table: torch.Tensor,
                     log_q: torch.Tensor, neg_ids: torch.Tensor,
                     pos_ids: torch.Tensor) -> torch.Tensor:
    """Per-token fused CE. hidden [T,D] (cast to fp32); table [V,D] in its
    native dtype; log_q [T,M]; neg_ids [T,M]; pos_ids [T] -> loss [T]
    fp32."""
    return SampledCEPerTokenFn.apply(
        hidden.float().contiguous(), table.contiguous(),
        log_q.float().contiguous(), neg_ids.long().contiguous(),
        pos_ids.long().contiguous())


class SampledCEFn(torch.autograd.Function):
    """(hidden [B,S,D], pos_emb [B,S,D], neg_emb [B,M,D], log_q [B,M],
    neg_ids, pos_ids) -> loss [B,S]. Gradients: hidden, pos_emb and neg_emb
    (in their dtypes) and log_q."""

    @staticmethod
    def forward(ctx, hidden, pos_emb, neg_emb, log_q, neg_ids, pos_ids):
        loss, lse = dispatch.sampled_ce(hidden, pos_emb, neg_emb, log_q,
                                        neg_ids, pos_ids)
        ctx.save_for_backward(hidden, pos_emb, neg_emb, log_q, neg_ids,
                              pos_ids, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, pos_emb, neg_emb, log_q, neg_ids, pos_ids, lse = \
            ctx.saved_tensors
        dh, dpe, dne, dlq = dispatch.sampled_ce_bwd(
            g.float().contiguous(), hidden, pos_emb, neg_emb, log_q, neg_ids,
            pos_ids, lse)
        return (dh.to(hidden.dtype), dpe.to(pos_emb.dtype),
                dne.to(neg_emb.dtype), dlq.to(log_q.dtype), None, None)


def sampled_ce_op(hidden: torch.Tensor, pos_emb: torch.Tensor,
                  neg_emb: torch.Tensor, log_q: torch.Tensor,
                  neg_ids: torch.Tensor, pos_ids: torch.Tensor
                  ) -> torch.Tensor:
    """Shared-negative fused CE. hidden [B,S,D] (cast to fp32); pos_emb
    [B,S,D] and neg_emb [B,M,D] gathered rows in the table's native dtype;
    log_q/neg_ids [B,M]; pos_ids [B,S] -> loss [B,S] fp32."""
    return SampledCEFn.apply(
        hidden.float().contiguous(), pos_emb.contiguous(),
        neg_emb.contiguous(), log_q.float().contiguous(),
        neg_ids.long().contiguous(), pos_ids.long().contiguous())
