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

`sampled_ce_pt_q_op` mirrors the quantized per-token op (reference
`ops.py:176-208`, `_pt_q_fwd` / `_pt_q_bwd`): the kernels read the int8 /
fp8 table and its per-row scales, and the master table is a dead input
that receives the kernels' scale-unaware d(table), the straight-through
gradient, so the optimizer keeps updating the master precision.
`sampled_ce_q_op` is the shared-negative twin (reference `ops.py:248-285`,
`_q_fwd` / `_q_bwd`): the kernels read the gathered low-bit rows and their
scales; the gathered master rows are dead inputs that receive the
scale-unaware dpe / dne.
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


class SampledCEPerTokenQFn(torch.autograd.Function):
    """(hidden, table, qdata, qscale, log_q, neg_ids, pos_ids) -> loss [T].
    `table` (the master) is never read; it receives d(table) in its dtype.
    Gradients: hidden, table and log_q."""

    @staticmethod
    def forward(ctx, hidden, table, qdata, qscale, log_q, neg_ids, pos_ids):
        loss, lse = dispatch.sampled_ce_pt(hidden, qdata, log_q, neg_ids,
                                           pos_ids, scale=qscale)
        ctx.save_for_backward(hidden, qdata, qscale, log_q, neg_ids,
                              pos_ids, lse)
        ctx.table_dtype = table.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, qdata, qscale, log_q, neg_ids, pos_ids, lse = \
            ctx.saved_tensors
        dh, dtab, dlq = dispatch.sampled_ce_pt_bwd(
            g.float().contiguous(), hidden, qdata, log_q, neg_ids, pos_ids,
            lse, scale=qscale)
        return (dh.to(hidden.dtype), dtab.to(ctx.table_dtype), None, None,
                dlq.to(log_q.dtype), None, None)


def sampled_ce_pt_q_op(hidden: torch.Tensor, table: torch.Tensor,
                       qdata: torch.Tensor, qscale: torch.Tensor,
                       log_q: torch.Tensor, neg_ids: torch.Tensor,
                       pos_ids: torch.Tensor) -> torch.Tensor:
    """Per-token fused CE over the quantized table. hidden [T,D]; table
    [V,D] the master (a dead input); qdata [V,D] int8 / fp8; qscale [V,1]
    fp32; log_q/neg_ids [T,M]; pos_ids [T] -> loss [T] fp32."""
    return SampledCEPerTokenQFn.apply(
        hidden.float().contiguous(), table, qdata.contiguous(),
        qscale.float().contiguous(), log_q.float().contiguous(),
        neg_ids.long().contiguous(), pos_ids.long().contiguous())


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


class SampledCEQFn(torch.autograd.Function):
    """(hidden, pos_emb, neg_emb, pos_q, pos_scale, neg_q, neg_scale, log_q,
    neg_ids, pos_ids) -> loss [B,S]. pos_emb / neg_emb (gathered master
    rows) are never read; they receive dpe / dne in their dtypes.
    Gradients: hidden, pos_emb, neg_emb and log_q."""

    @staticmethod
    def forward(ctx, hidden, pos_emb, neg_emb, pos_q, pos_scale, neg_q,
                neg_scale, log_q, neg_ids, pos_ids):
        loss, lse = dispatch.sampled_ce(hidden, pos_q, neg_q, log_q, neg_ids,
                                        pos_ids, pos_scale=pos_scale,
                                        neg_scale=neg_scale)
        ctx.save_for_backward(hidden, pos_q, pos_scale, neg_q, neg_scale,
                              log_q, neg_ids, pos_ids, lse)
        ctx.dtypes = (pos_emb.dtype, neg_emb.dtype)
        return loss

    @staticmethod
    def backward(ctx, g):
        (hidden, pos_q, pos_scale, neg_q, neg_scale, log_q, neg_ids, pos_ids,
         lse) = ctx.saved_tensors
        dh, dpe, dne, dlq = dispatch.sampled_ce_bwd(
            g.float().contiguous(), hidden, pos_q, neg_q, log_q, neg_ids,
            pos_ids, lse, pos_scale=pos_scale, neg_scale=neg_scale)
        return (dh.to(hidden.dtype), dpe.to(ctx.dtypes[0]),
                dne.to(ctx.dtypes[1]), None, None, None, None,
                dlq.to(log_q.dtype), None, None)


def sampled_ce_q_op(hidden: torch.Tensor, pos_emb: torch.Tensor,
                    neg_emb: torch.Tensor, pos_q: torch.Tensor,
                    pos_scale: torch.Tensor, neg_q: torch.Tensor,
                    neg_scale: torch.Tensor, log_q: torch.Tensor,
                    neg_ids: torch.Tensor, pos_ids: torch.Tensor
                    ) -> torch.Tensor:
    """Shared-negative fused CE over gathered quantized rows. hidden
    [B,S,D]; pos_emb [B,S,D] / neg_emb [B,M,D] the gathered master rows
    (dead inputs); pos_q / neg_q the gathered int8 / fp8 rows with
    pos_scale [B,S,1] / neg_scale [B,M,1] fp32; log_q/neg_ids [B,M];
    pos_ids [B,S] -> loss [B,S] fp32."""
    return SampledCEQFn.apply(
        hidden.float().contiguous(), pos_emb, neg_emb, pos_q.contiguous(),
        pos_scale.float().contiguous(), neg_q.contiguous(),
        neg_scale.float().contiguous(), log_q.float().contiguous(),
        neg_ids.long().contiguous(), pos_ids.long().contiguous())
