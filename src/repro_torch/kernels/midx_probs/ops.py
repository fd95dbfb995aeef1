"""Public wrapper: MIDX proposal tables, differentiable.

Mirrors `src/repro/kernels/midx_probs/ops.py` (`proposal_tables` :63 and
the custom-VJP `_tables_op` :33-60). The forward goes through
`kernels.dispatch.midx_probs` (the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor); the backward recomputes through the plain
version, as `_tables_bwd` (:48) does — three K-wide GEMMs, [T, K]
transients only — so d(tables)/dz and d(tables)/d(codebooks) are ready for
the training slice. Unlike the reference there is no `use_kernel` or
`interpret` switch and no padding of T: the device decides, and the kernel
masks the ragged edge itself.

`proposal_tables_q` mirrors the quantized twin (reference `ops.py:94-148`,
`_tables_q_op` / `_tables_q_bwd`): the low-bit codebooks and their [K, 1]
scales go to the kernel, and the backward gives d(tables)/dz only,
through the plain version; the low-bit codebooks and their scales are
quantization artifacts, not trained, and get no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.index.build import MultiIndex
from repro_torch.kernels import dispatch
from repro_torch.kernels.midx_probs.ref import midx_probs_ref


class TablesFn(torch.autograd.Function):
    """(z2d [T,D], cb1, cb2, counts, split) -> (s1, s2, log_psi, lse)."""

    @staticmethod
    def forward(ctx, z2d, cb1, cb2, counts, split: bool):
        ctx.save_for_backward(z2d, cb1, cb2, counts)
        ctx.split = split
        return dispatch.midx_probs(z2d, cb1, cb2, counts, split=split)

    @staticmethod
    def backward(ctx, g1, g2, g3, g4):
        z2d, cb1, cb2, counts = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(n)
                      for x, n in zip((z2d, cb1, cb2), need)]
            outs = midx_probs_ref(*leaves, counts, split=ctx.split)
            wrt = [x for x, n in zip(leaves, need) if n]
            got = iter(torch.autograd.grad(outs, wrt, (g1, g2, g3, g4)))
        grads = [next(got) if n else None for n in need]
        return (*grads, None, None)


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
        ctx.save_for_backward(z2d, qcb1, sc1, qcb2, sc2, counts)
        ctx.split = split
        return dispatch.midx_probs(z2d, qcb1, qcb2, counts, split=split,
                                   scale1=sc1, scale2=sc2)

    @staticmethod
    def backward(ctx, g1, g2, g3, g4):
        z2d, qcb1, sc1, qcb2, sc2, counts = ctx.saved_tensors
        with torch.enable_grad():
            z = z2d.detach().requires_grad_(True)
            outs = midx_probs_ref(z, qcb1, qcb2, counts, split=ctx.split,
                                  scale1=sc1, scale2=sc2)
            dz, = torch.autograd.grad(outs, (z,), (g1, g2, g3, g4))
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
