"""Plain torch versions of the MIDX proposal-table kernels.

`midx_probs_ref` mirrors `src/repro/kernels/midx_probs/ref.py:8-30`, with
its quantized mode (int8 / fp8 codebooks and [K, 1] fp32 scales).
`midx_probs_bwd_ref` is the closed form of its VJP (the gradient the
reference's `_tables_bwd` / `_tables_q_bwd` take by differentiating the
oracle), from the forward's outputs. The CPU tests run both, and
`chip_smoke.py` holds the CUDA kernels against them on the card. The main
path never calls them on a CUDA tensor.
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


def midx_probs_bwd_ref(s1, s2, lpsi, lse, g1, g2, g3, g4, cb1, cb2, counts,
                       *, split: bool, scale1=None, scale2=None,
                       with_ds: bool = False):
    """The VJP of `midx_probs_ref` w.r.t. z, in closed form: the forward's
    outputs s1, s2, lpsi [T, K], lse [T], their cotangents g1, g2, g3
    [T, K], g4 [T], the codebooks as the forward takes them and counts
    [K, K] -> (dz [T, D], ds1, ds2): ds1/ds2 [T, K] are the gradients of
    the dot products z·cbᵀ (times the scales in the quantized mode), given
    where `with_ds` (d(codebooks) = dsᵀ·z), else None.

    The shift c2 = max s2 reaches log_psi directly and through exp(s2 -
    c2); the two cancel where psi is at or above the 1e-30 floor, and a
    floored psi (a zero row of counts) keeps the direct path, which amax
    sends to its argmax, split evenly between ties."""
    gp = g4[:, None] * torch.exp(s1 + lpsi - lse[:, None])
    ds1 = g1 + gp
    a = g3 + gp
    c2 = torch.amax(s2, dim=-1, keepdim=True)
    e = torch.exp(s2 - c2)
    cnt = counts.float()
    psi = e @ cnt.T
    live = psi >= 1e-30
    r = torch.where(live, a / psi, 0.0)
    top = (s2 == c2).float()
    floored = torch.where(live, 0.0, a).sum(-1, keepdim=True)
    ds2 = g2 + e * (r @ cnt)
    ds2 = ds2 + top * (floored / top.sum(-1, keepdim=True))
    if scale1 is not None:
        ds1 = ds1 * scale1.float().reshape(1, -1)
        ds2 = ds2 * scale2.float().reshape(1, -1)
    cbf1, cbf2 = cb1.float(), cb2.float()
    if split:
        dz = torch.cat([ds1 @ cbf1, ds2 @ cbf2], dim=-1)
    else:
        dz = ds1 @ cbf1 + ds2 @ cbf2
    return (dz, ds1, ds2) if with_ds else (dz, None, None)
