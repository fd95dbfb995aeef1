"""Public wrapper: the per-token sampled-softmax CE, differentiable.

Mirrors `src/repro/kernels/sampled_ce/ops.py::sampled_ce_pt_op` (:52-80,
the custom VJP `_pt_fwd` / `_pt_bwd`). The forward goes through
`kernels.dispatch.sampled_ce_pt` and saves its lse; the backward goes
through `kernels.dispatch.sampled_ce_pt_bwd` — the CUDA kernels for CUDA
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
