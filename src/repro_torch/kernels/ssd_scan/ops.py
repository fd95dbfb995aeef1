"""Public wrapper: the chunked SSD scan, differentiable.

Mirrors `src/repro/kernels/ssd_scan/ops.py` (`ssd_scan_op` :24-43): the
forward goes through `kernels.dispatch.ssd_scan` (the CUDA kernel for a
CUDA tensor, `ref.ssd_scan_ref` for a CPU tensor) and saves only its
inputs; the backward recomputes through the plain version under autograd,
as the reference's `_bwd` (:36-41) recomputes through its oracle. The JAX
package has no backward kernel to port. Unlike the reference it returns
h_last too, and takes a gradient for it (or None); it returns gradients
for both adt and dt, so a's gradient flows through adt = a·dt.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


class SsdScanFn(torch.autograd.Function):
    """(x [Bt,S,H,P], bmat, cmat [Bt,S,N], adt, dt [Bt,S,H], chunk) ->
    (y [Bt,S,H,P], h_last [Bt,H,N,P]), fp32."""

    @staticmethod
    def forward(ctx, x, bmat, cmat, adt, dt, chunk: int):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, bmat, cmat, adt, dt)
        ctx.chunk = chunk
        return dispatch.ssd_scan(x, bmat, cmat, adt, dt, chunk=chunk)

    @staticmethod
    def backward(ctx, g_y, g_h):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ssd_scan_ref(*inputs, chunk=ctx.chunk)
        pairs = [(o, g) for o, g in zip(outs, (g_y, g_h)) if g is not None]
        if not pairs:
            return None, None, None, None, None, None
        grads = torch.autograd.grad([o for o, _ in pairs],
                                    inputs, [g for _, g in pairs],
                                    allow_unused=True)
        return (*grads, None)


def ssd_scan_op(x: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                adt: torch.Tensor, dt: torch.Tensor, chunk: int):
    """The scan of `models.mamba2.apply_mamba2`: S % chunk == 0."""
    return SsdScanFn.apply(x.contiguous(), bmat.contiguous(),
                           cmat.contiguous(), adt.contiguous(),
                           dt.contiguous(), chunk)
