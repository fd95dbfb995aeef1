"""Plain torch version of the fused MIDX proposal-table kernel.

Mirrors `src/repro/kernels/midx_probs/ref.py:8-30`, with its quantized
mode (int8 / fp8 codebooks and [K, 1] fp32 scales). The CPU tests
run it, `chip_smoke.py` holds the CUDA kernel against it on the card, and
the autograd wrapper's backward recomputes through it. The main path never
calls it on a CUDA tensor.
"""
from __future__ import annotations

import torch


def midx_probs_ref(z: torch.Tensor, cb1: torch.Tensor, cb2: torch.Tensor,
                   counts: torch.Tensor, *, split: bool,
                   scale1: torch.Tensor | None = None,
                   scale2: torch.Tensor | None = None):
    """z [T, D]; cb1/cb2 [K, Dc] (Dc = D/2 for PQ-split, D for RQ);
    counts [K, K]. Returns (s1, s2, log_psi [T, K], lse [T]):
      log_psi[t,k1] = log Σ_k2 counts[k1,k2]·exp(s2[t,k2]),
      lse[t]        = logsumexp_k1(s1 + log_psi)  (Eq.(6) normalizer).
    scale1/scale2 given: quantized mode, cb1/cb2 are the low-bit codebooks
    and the [K, 1] fp32 scales multiply the scores after the dot.
    """
    zf = z.float()
    if split:
        d = z.shape[-1]
        z1, z2 = zf[:, : d // 2], zf[:, d // 2:]
    else:
        z1 = z2 = zf
    s1 = z1 @ cb1.float().T
    s2 = z2 @ cb2.float().T
    if scale1 is not None:
        s1 = s1 * scale1.float().reshape(1, -1)
        s2 = s2 * scale2.float().reshape(1, -1)
    c2 = torch.amax(s2, dim=-1, keepdim=True)
    psi = torch.exp(s2 - c2) @ counts.float().T
    log_psi = torch.log(torch.clamp(psi, min=1e-30)) + c2
    lse = torch.logsumexp(s1 + log_psi, dim=-1)
    return s1, s2, log_psi, lse
