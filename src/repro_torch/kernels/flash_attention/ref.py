"""Plain torch versions of the flash-attention kernel.

Mirrors the chunked online-softmax forward of
`src/repro/models/attention.py` (`_block_mask` :87-95, `_flash_fwd`
:98-144): the same chunk loops, the same NEG_INF = -1e30 masking, fp32
arithmetic and the `max(l, 1e-30)` floor. The dense oracle of
`src/repro/kernels/flash_attention/ref.py` (`attention_ref`, :8-21) is
the port's `models.attention._direct_attention` with q_offset = Sk - Sq.

`flash_fwd_ref` is the plain version of the CUDA kernel
`csrc/flash_attention.cu`: the CPU path and the tests run it, and
`chip_smoke.py` holds the kernel against it on the card; the card's main
path never calls it. The Pallas kernel's own function is its case
`window=None, q_offset = sk - sq`.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def block_mask(iq: int, ik: int, q_chunk: int, kv_chunk: int, q_offset: int,
               causal: bool, window: int | None, device) -> torch.Tensor:
    """Boolean [q_chunk, kv_chunk] allowed-mask of score block (iq, ik)."""
    qi = (iq * q_chunk + torch.arange(q_chunk, device=device)[:, None]
          + q_offset)
    kj = ik * kv_chunk + torch.arange(kv_chunk, device=device)[None, :]
    ok = torch.ones((q_chunk, kv_chunk), dtype=torch.bool, device=device)
    if causal:
        ok &= kj <= qi
    if window is not None:
        ok &= kj > qi - window
    return ok


def check_chunks(sq: int, sk: int, q_chunk: int, kv_chunk: int) -> None:
    if q_chunk < 1 or kv_chunk < 1 or sq % q_chunk or sk % kv_chunk:
        raise ValueError(f"chunked attention needs Sq % q_chunk == 0 and "
                         f"Sk % kv_chunk == 0, got Sq={sq} q_chunk={q_chunk} "
                         f"Sk={sk} kv_chunk={kv_chunk}")


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: int | None, q_offset: int,
                  q_chunk: int, kv_chunk: int):
    """Online-softmax forward. Returns (out [B,Sq,H,hd] in q.dtype,
    lse [B,KV,G,Sq] fp32).

    Memory: one (q_chunk x kv_chunk) score block at a time; per-chunk casts,
    so no fp32 copy of the whole K/V is made."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    check_chunks(sq, sk, q_chunk, kv_chunk)
    g = h // kv
    nq, nk = sq // q_chunk, sk // kv_chunk
    scale = hd ** -0.5
    qg = q.reshape(b, sq, kv, g, hd)
    outs, lses = [], []
    for iq in range(nq):
        qs = qg[:, iq * q_chunk:(iq + 1) * q_chunk].float() * scale
        acc = q.new_zeros((b, kv, g, q_chunk, hd), dtype=torch.float32)
        m = q.new_full((b, kv, g, q_chunk), NEG_INF, dtype=torch.float32)
        l = q.new_zeros((b, kv, g, q_chunk), dtype=torch.float32)
        for ik in range(nk):
            ks = k[:, ik * kv_chunk:(ik + 1) * kv_chunk].float()
            vs = v[:, ik * kv_chunk:(ik + 1) * kv_chunk].float()
            s = torch.einsum("bqkgh,bmkh->bkgqm", qs, ks)
            ok = block_mask(iq, ik, q_chunk, kv_chunk, q_offset, causal,
                            window, q.device)
            s = torch.where(ok, s, s.new_tensor(NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgqm,bmkh->bkgqh",
                                                        p, vs)
            m = m_new
        lc = torch.clamp(l, min=1e-30)
        out = acc / lc[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, h, hd))
        lses.append(m + torch.log(lc))                    # [b,kv,g,qc]
    out = torch.cat(outs, dim=1).to(q.dtype)
    return out, torch.cat(lses, dim=-1)
