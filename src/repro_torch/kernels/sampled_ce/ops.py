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


# ------------------------------------------------------------ partial mode
# Mirrors the reference's partial ops (`ops.py:93-208`, `:211-245` and
# `:287-322`: `sampled_ce_partial_op`, `sampled_ce_pt_partial_op`,
# `sampled_ce_pt_q_partial_op`, `sampled_ce_q_partial_op`): each returns a
# vocab shard's partial lse [T] (or [B, S]) and saves it; its backward runs
# the kernels' partial mode, whose weights are exp(corr − partial), and the
# cross-shard merge (`core.sampled_softmax.merge_sampled_softmax_loss`)
# supplies the cotangent exp(partial − lse), so the chain rule gives the
# global softmax weights. `num_neg` is the global M. The shared twins take
# no positive rows (the reference passes zeros and gets a zero dpe back).

class SampledCEPerTokenPartialFn(torch.autograd.Function):
    """(hidden [T,D], table [rows,D], log_q [T,M], neg_ids, pos_ids,
    num_neg) -> partial lse [T]. Gradients: hidden, table and log_q."""

    @staticmethod
    def forward(ctx, hidden, table, log_q, neg_ids, pos_ids, num_neg):
        lse = dispatch.sampled_ce_pt_partial(hidden, table, log_q, neg_ids,
                                             pos_ids, num_neg)
        ctx.save_for_backward(hidden, table, log_q, neg_ids, pos_ids, lse)
        ctx.num_neg = num_neg
        return lse

    @staticmethod
    def backward(ctx, g):
        hidden, table, log_q, neg_ids, pos_ids, lse = ctx.saved_tensors
        dh, dtab, dlq = dispatch.sampled_ce_pt_partial_bwd(
            g.float().contiguous(), hidden, table, log_q, neg_ids, pos_ids,
            lse, ctx.num_neg)
        return (dh.to(hidden.dtype), dtab.to(table.dtype),
                dlq.to(log_q.dtype), None, None, None)


def sampled_ce_pt_partial_op(hidden, table, log_q, neg_ids, pos_ids,
                             num_neg: int) -> torch.Tensor:
    """Per-token partial lse. table [rows, D] this shard's rows in their
    native dtype; neg_ids [T, M] local rows (a non-owned negative clipped
    to 0 with log_q = −NEG_INF); pos_ids [T] local or −1 -> [T] fp32."""
    return SampledCEPerTokenPartialFn.apply(
        hidden.float().contiguous(), table.contiguous(),
        log_q.float().contiguous(), neg_ids.long().contiguous(),
        pos_ids.long().contiguous(), int(num_neg))


class SampledCEPerTokenQPartialFn(torch.autograd.Function):
    """(hidden, table, qdata, qscale, log_q, neg_ids, pos_ids, num_neg) ->
    partial lse [T]; `table` (the master) is a dead input that receives
    the scale-unaware d(table)."""

    @staticmethod
    def forward(ctx, hidden, table, qdata, qscale, log_q, neg_ids, pos_ids,
                num_neg):
        lse = dispatch.sampled_ce_pt_partial(hidden, qdata, log_q, neg_ids,
                                             pos_ids, num_neg, scale=qscale)
        ctx.save_for_backward(hidden, qdata, qscale, log_q, neg_ids,
                              pos_ids, lse)
        ctx.table_dtype, ctx.num_neg = table.dtype, num_neg
        return lse

    @staticmethod
    def backward(ctx, g):
        hidden, qdata, qscale, log_q, neg_ids, pos_ids, lse = \
            ctx.saved_tensors
        dh, dtab, dlq = dispatch.sampled_ce_pt_partial_bwd(
            g.float().contiguous(), hidden, qdata, log_q, neg_ids, pos_ids,
            lse, ctx.num_neg, scale=qscale)
        return (dh.to(hidden.dtype), dtab.to(ctx.table_dtype), None, None,
                dlq.to(log_q.dtype), None, None, None)


def sampled_ce_pt_q_partial_op(hidden, table, qdata, qscale, log_q, neg_ids,
                               pos_ids, num_neg: int) -> torch.Tensor:
    """Quantized per-token partial lse: qdata [rows, D] int8 / fp8 and
    qscale [rows, 1] this shard's; the rest as sampled_ce_pt_partial_op."""
    return SampledCEPerTokenQPartialFn.apply(
        hidden.float().contiguous(), table, qdata.contiguous(),
        qscale.float().contiguous(), log_q.float().contiguous(),
        neg_ids.long().contiguous(), pos_ids.long().contiguous(),
        int(num_neg))


class SampledCEPartialFn(torch.autograd.Function):
    """(hidden [B,S,D], neg_emb [B,M,D], log_q [B,M], neg_ids, pos_ids,
    num_neg) -> partial lse [B,S]. Gradients: hidden, neg_emb, log_q."""

    @staticmethod
    def forward(ctx, hidden, neg_emb, log_q, neg_ids, pos_ids, num_neg):
        lse = dispatch.sampled_ce_partial(hidden, neg_emb, log_q, neg_ids,
                                          pos_ids, num_neg)
        ctx.save_for_backward(hidden, neg_emb, log_q, neg_ids, pos_ids, lse)
        ctx.num_neg = num_neg
        return lse

    @staticmethod
    def backward(ctx, g):
        hidden, neg_emb, log_q, neg_ids, pos_ids, lse = ctx.saved_tensors
        dh, dne, dlq = dispatch.sampled_ce_partial_bwd(
            g.float().contiguous(), hidden, neg_emb, log_q, neg_ids, pos_ids,
            lse, ctx.num_neg)
        return (dh.to(hidden.dtype), dne.to(neg_emb.dtype),
                dlq.to(log_q.dtype), None, None, None)


def sampled_ce_partial_op(hidden, neg_emb, log_q, neg_ids, pos_ids,
                          num_neg: int) -> torch.Tensor:
    """Shared-negative partial lse. neg_emb [B, M, D] this shard's
    gathered rows (native dtype; a non-owned draw's row is local row 0
    with log_q = −NEG_INF); pos_ids [B, S] local or −1 -> [B, S] fp32."""
    return SampledCEPartialFn.apply(
        hidden.float().contiguous(), neg_emb.contiguous(),
        log_q.float().contiguous(), neg_ids.long().contiguous(),
        pos_ids.long().contiguous(), int(num_neg))


class SampledCEQPartialFn(torch.autograd.Function):
    """(hidden, neg_emb, neg_q, neg_scale, log_q, neg_ids, pos_ids,
    num_neg) -> partial lse [B,S]; neg_emb (the gathered master rows) is a
    dead input that receives the scale-unaware dne."""

    @staticmethod
    def forward(ctx, hidden, neg_emb, neg_q, neg_scale, log_q, neg_ids,
                pos_ids, num_neg):
        lse = dispatch.sampled_ce_partial(hidden, neg_q, log_q, neg_ids,
                                          pos_ids, num_neg,
                                          neg_scale=neg_scale)
        ctx.save_for_backward(hidden, neg_q, neg_scale, log_q, neg_ids,
                              pos_ids, lse)
        ctx.dtype, ctx.num_neg = neg_emb.dtype, num_neg
        return lse

    @staticmethod
    def backward(ctx, g):
        hidden, neg_q, neg_scale, log_q, neg_ids, pos_ids, lse = \
            ctx.saved_tensors
        dh, dne, dlq = dispatch.sampled_ce_partial_bwd(
            g.float().contiguous(), hidden, neg_q, log_q, neg_ids, pos_ids,
            lse, ctx.num_neg, neg_scale=neg_scale)
        return (dh.to(hidden.dtype), dne.to(ctx.dtype), None, None,
                dlq.to(log_q.dtype), None, None, None)


def sampled_ce_q_partial_op(hidden, neg_emb, neg_q, neg_scale, log_q,
                            neg_ids, pos_ids, num_neg: int) -> torch.Tensor:
    """Quantized shared-negative partial lse: neg_q [B, M, D] the gathered
    int8 / fp8 rows, neg_scale [B, M, 1] fp32; neg_emb the gathered master
    rows (a dead input)."""
    return SampledCEQPartialFn.apply(
        hidden.float().contiguous(), neg_emb, neg_q.contiguous(),
        neg_scale.float().contiguous(), log_q.float().contiguous(),
        neg_ids.long().contiguous(), pos_ids.long().contiguous(),
        int(num_neg))
