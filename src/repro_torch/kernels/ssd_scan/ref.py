"""Plain torch version of the chunked SSD scan kernel.

Mirrors the chunk body of `src/repro/models/mamba2.py::apply_mamba2`
(:102-119), which is the function of the Pallas kernel
`src/repro/kernels/ssd_scan/ssd_scan.py` (`_kernel` :24) and of its oracle
`ref.py::ssd_scan_ref` (:9), over the model's layout, fp32. Per (batch,
head) and chunk of Q rows, with the carry h [N, P] starting at 0:
    cum = cumsum(a·dt) over the chunk;   CB = C · Bᵀ
    y   = (CB ⊙ L) · (dt·x) + e^{cum} ⊙ (C · h),  L = tril(e^{cum_i − cum_j})
    h'  = e^{cum_Q} · h + Bᵀ · (e^{cum_Q − cum} ⊙ dt·x)

One departure: L is formed as exp(where(mask, decay, −inf)), masked BEFORE
the exponential, where the reference writes where(mask, exp(decay), 0)
(`mamba2.py:108`, `ssd_scan/ref.py:75`). Above the diagonal decay =
cum_i − cum_j is positive and, for a long enough chunk, exp overflows to
inf; `where` drops it going forward, but its gradient is 0 · inf = NaN in
a, dt and everything upstream. The kept entries are the same exps of the
same numbers, so the forward output is unchanged and the gradients stay
finite.

The prefix sum cum accumulates in fp64 and rounds each row to fp32, as
the CUDA kernel does and as torch's CPU cumsum of fp32 does anyway (so on
the CPU this is the plain fp32 cumsum, bit for bit). torch's CUDA cumsum
accumulates in fp32: its rounding, some ulps of |cum| ~ 200 at Q = 256
(an ulp there is 1.5e-5), reaches y through e^{cum_i − cum_j} at the size
of the 1e-4 bound the kernel is held to.

The Pallas kernel writes only y; this version, like the CUDA kernel, also
returns h_last, the carry after the last chunk, which
`apply_mamba2(return_state=True)` needs (`mamba2.py:119, 135-137`).
`ssd_scan_ref` is the kernel's plain version: the CPU path and the tests
run it, `chip_smoke.py` holds the kernel against it on the card, and the
backward of `ops.SsdScanFn` recomputes through it.
"""
from __future__ import annotations

import torch


def ssd_scan_ref(x: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                 adt: torch.Tensor, dt: torch.Tensor, *, chunk: int):
    """x [Bt,S,H,P]; bmat/cmat [Bt,S,N] (shared by all heads); adt = a·dt
    and dt [Bt,S,H] -> (y [Bt,S,H,P], h_last [Bt,H,N,P]), both fp32.
    Inputs of another float type are upcast to fp32 first.

    Every chunk's own terms (y1, and the state increment s_c) are formed
    in one batched pass over a chunk axis; only the carry h runs chunk by
    chunk, as h_c = e^{cum_Q}·h_{c−1} + s_c, and y2 takes the carry each
    chunk starts from. The per-chunk arithmetic is the reference's; the
    batching keeps the op count, and the launches of the training step's
    recompute backward on the card, independent of S / chunk."""
    x, bmat, cmat, adt, dt = (t.float() for t in (x, bmat, cmat, adt, dt))
    bt, s, nh, p = x.shape
    n = bmat.shape[-1]
    if chunk < 1 or s % chunk:
        raise ValueError(f"ssd_scan needs S % chunk == 0, got S={s} "
                         f"chunk={chunk}")
    nc, q = s // chunk, chunk
    xc = x.reshape(bt, nc, q, nh, p)
    bc, cc = bmat.reshape(bt, nc, q, n), cmat.reshape(bt, nc, q, n)
    dtc = dt.reshape(bt, nc, q, nh)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=x.device))[:, :, None]
    cum = torch.cumsum(adt.reshape(bt, nc, q, nh).double(),
                       dim=2).float()                           # [B,C,Q,H]
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)                # [B,C,Q,Q]
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # [B,C,i,j,H]
    l_mat = torch.exp(torch.where(mask, decay,
                                  decay.new_tensor(float("-inf"))))
    dtx = xc * dtc[..., None]                                   # [B,C,Q,H,P]
    y1 = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * l_mat, dtx)
    seg = torch.exp(cum[:, :, -1:, :] - cum)                    # [B,C,Q,H]
    s_c = torch.einsum("bcjn,bcjhp->bchnp", bc, dtx * seg[..., None])
    decay_c = torch.exp(cum[:, :, -1, :])[..., None, None]      # [B,C,H,1,1]
    h = x.new_zeros((bt, nh, n, p))
    starts = []
    for c in range(nc):
        starts.append(h)
        h = decay_c[:, c] * h + s_c[:, c]
    h_prev = torch.stack(starts, dim=1) if starts else \
        x.new_zeros((bt, 0, nh, n, p))                          # [B,C,H,N,P]
    y2 = torch.exp(cum)[..., None] * torch.einsum("bcin,bchnp->bcihp", cc,
                                                  h_prev)
    return (y1 + y2).reshape(bt, s, nh, p), h
