"""Public wrapper: MIDX proposal tables, differentiable.

Mirrors `src/repro/kernels/midx_probs/ops.py` (`proposal_tables` :63 and
the custom-VJP `_tables_op` :33-60). Both directions go through
`kernels.dispatch` (the CUDA kernel for a CUDA tensor, the plain version
for a CPU tensor): the forward through `midx_probs`, the backward through
`midx_probs_bwd`, the closed form of the reference's VJP (`_tables_bwd`
:48, which differentiates a recompute through the oracle) evaluated from
the forward's saved outputs, so nothing is recomputed. d(tables)/dz comes
from the kernel; d(tables)/d(codebooks) = dsᵀ·z is a torch.matmul on the
kernel's ds, taken only where a codebook asks for a gradient. Unlike the
reference there is no `use_kernel` or `interpret` switch and no padding
of T: the device decides, and the kernels mask the ragged edge
themselves.

`proposal_tables_q` mirrors the quantized twin (reference `ops.py:94-148`,
`_tables_q_op` / `_tables_q_bwd`): the low-bit codebooks and their [K, 1]
scales go to both kernels, and the backward gives d(tables)/dz only; the
low-bit codebooks and their scales are quantization artifacts, not
trained, and get no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.index.build import MultiIndex
from repro_torch.kernels import dispatch


class TablesFn(torch.autograd.Function):
    """(z2d [T,D], cb1, cb2, counts, split) -> (s1, s2, log_psi, lse)."""

    @staticmethod
    def forward(ctx, z2d, cb1, cb2, counts, split: bool):
        out = dispatch.midx_probs(z2d, cb1, cb2, counts, split=split)
        want_cb = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        ctx.save_for_backward(*out, cb1, cb2, counts,
                              z2d if want_cb else None)
        ctx.split = split
        return out

    @staticmethod
    def backward(ctx, g1, g2, g3, g4):
        s1, s2, lpsi, lse, cb1, cb2, counts, z2d = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        dz, ds1, ds2 = dispatch.midx_probs_bwd(
            s1, s2, lpsi, lse, *(g.contiguous() for g in (g1, g2, g3, g4)),
            cb1, cb2, counts, split=ctx.split, with_ds=need[1] or need[2])
        dcb1 = dcb2 = None
        if need[1] or need[2]:
            z1, z2 = z2d.chunk(2, dim=1) if ctx.split else (z2d, z2d)
            dcb1 = ds1.T @ z1 if need[1] else None
            dcb2 = ds2.T @ z2 if need[2] else None
        return dz if need[0] else None, dcb1, dcb2, None, None


def proposal_tables(index: MultiIndex, z: torch.Tensor):
    """z [..., D] -> (s1, s2, log_psi [..., K], lse [...]); the semantics of
    `repro_torch.core.midx.twostage_tables`, differentiable w.r.t. z and
    the codebooks."""
    lead = z.shape[:-1]
    z2d = z.reshape(-1, z.shape[-1]).float().contiguous()
    s1, s2, lpsi, lse = TablesFn.apply(
        z2d, index.codebook1.float().contiguous(),
        index.codebook2.float().contiguous(),
        index.counts.float().contiguous(), index.kind == "pq")
    k = s1.shape[-1]
    return (s1.reshape(*lead, k), s2.reshape(*lead, k),
            lpsi.reshape(*lead, k), lse.reshape(lead))


class TablesQFn(torch.autograd.Function):
    """(z2d [T,D], qcb1, sc1, qcb2, sc2, counts, split) -> (s1, s2,
    log_psi, lse); the gradient reaches z2d alone."""

    @staticmethod
    def forward(ctx, z2d, qcb1, sc1, qcb2, sc2, counts, split: bool):
        out = dispatch.midx_probs(z2d, qcb1, qcb2, counts, split=split,
                                  scale1=sc1, scale2=sc2)
        ctx.save_for_backward(*out, qcb1, sc1, qcb2, sc2, counts)
        ctx.split = split
        return out

    @staticmethod
    def backward(ctx, g1, g2, g3, g4):
        s1, s2, lpsi, lse, qcb1, sc1, qcb2, sc2, counts = ctx.saved_tensors
        dz, _, _ = dispatch.midx_probs_bwd(
            s1, s2, lpsi, lse, *(g.contiguous() for g in (g1, g2, g3, g4)),
            qcb1, qcb2, counts, split=ctx.split, scale1=sc1, scale2=sc2)
        return dz, None, None, None, None, None, None


def proposal_tables_q(index: MultiIndex, qcb1: torch.Tensor,
                      sc1: torch.Tensor, qcb2: torch.Tensor,
                      sc2: torch.Tensor, z: torch.Tensor):
    """Quantized-codebook proposal tables: `index` gives the kind and the
    counts, qcb1/qcb2 are the low-bit codebooks with [K, 1] fp32 scales.
    z [..., D] -> (s1, s2, log_psi [..., K], lse [...]), differentiable
    w.r.t. z."""
    lead = z.shape[:-1]
    z2d = z.reshape(-1, z.shape[-1]).float().contiguous()
    s1, s2, lpsi, lse = TablesQFn.apply(
        z2d, qcb1.contiguous(), sc1.float().reshape(-1).contiguous(),
        qcb2.contiguous(), sc2.float().reshape(-1).contiguous(),
        index.counts.float().contiguous(), index.kind == "pq")
    k = s1.shape[-1]
    return (s1.reshape(*lead, k), s2.reshape(*lead, k),
            lpsi.reshape(*lead, k), lse.reshape(lead))
