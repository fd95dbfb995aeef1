"""Public wrapper: chunked online-softmax attention, differentiable.

Mirrors `_flash_attention_xla` of `src/repro/models/attention.py`
(:216-234): the forward goes through `kernels.dispatch.flash_attention`
(the CUDA kernel for a CUDA tensor, `ref.flash_fwd_ref` for a CPU tensor)
and saves only (q, k, v, out, lse); the backward is the port of
`_flash_bwd` (:147-213), the blockwise recompute in plain torch, fp32,
one (q_chunk x kv_chunk) score block at a time.

Why the backward is no kernel: the JAX package computes it outside any
Pallas kernel. Its model path runs the XLA scan of `_flash_bwd`, and its
Pallas op's own VJP recomputes through the jnp oracle
(`kernels/flash_attention/ops.py:27-31`), which builds the whole
[B, KV, G, Sq, Sk] probabilities; that VJP is not ported. A hand-written
backward is speed work (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention.ref import (NEG_INF, block_mask,
                                                     check_chunks)


def flash_bwd(causal: bool, window, q_chunk: int, kv_chunk: int,
              q_offset: int, res, d_out: torch.Tensor):
    """Blockwise recompute backward (flash-attention backward formulas):
    ds = p * (d_o . v^T - rowsum(d_o * o)); dq += scale * ds . k;
    dk += ds^T . (scale * q); dv += p^T . d_o. Returns (dq, dk, dv) in the
    inputs' dtypes; dk is the gradient with respect to the unscaled k,
    since the scores use the scaled q."""
    q, k, v, out, lse = res
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    nq, nk = sq // q_chunk, sk // kv_chunk
    scale = hd ** -0.5
    qg = q.reshape(b, sq, kv, g, hd)
    og = out.reshape(b, sq, kv, g, hd)
    dg = d_out.reshape(b, sq, kv, g, hd)
    dk = q.new_zeros((b, sk, kv, hd), dtype=torch.float32)
    dv = q.new_zeros((b, sk, kv, hd), dtype=torch.float32)
    dqs = []
    for iq in range(nq):
        rows = slice(iq * q_chunk, (iq + 1) * q_chunk)
        qs = qg[:, rows].float() * scale
        os_ = og[:, rows].float()
        ds_out = dg[:, rows].float()
        lse_q = lse[..., rows]                                # [b,kv,g,qc]
        delta = torch.einsum("bqkgh,bqkgh->bkgq", ds_out, os_)
        dq_blk = q.new_zeros((b, q_chunk, kv, g, hd), dtype=torch.float32)
        for ik in range(nk):
            cols = slice(ik * kv_chunk, (ik + 1) * kv_chunk)
            ks = k[:, cols].float()
            vs = v[:, cols].float()
            s = torch.einsum("bqkgh,bmkh->bkgqm", qs, ks)
            ok = block_mask(iq, ik, q_chunk, kv_chunk, q_offset, causal,
                            window, q.device)
            s = torch.where(ok, s, s.new_tensor(NEG_INF))
            p = torch.exp(s - lse_q[..., None])               # [b,kv,g,qc,m]
            dp = torch.einsum("bqkgh,bmkh->bkgqm", ds_out, vs)
            ds = p * (dp - delta[..., None])
            dq_blk = dq_blk + scale * torch.einsum("bkgqm,bmkh->bqkgh", ds,
                                                   ks)
            dk[:, cols] += torch.einsum("bkgqm,bqkgh->bmkh", ds, qs)
            dv[:, cols] += torch.einsum("bkgqm,bqkgh->bmkh", p, ds_out)
        dqs.append(dq_blk)
    dq = torch.cat(dqs, dim=1).reshape(b, sq, h, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """(q [B,Sq,H,hd], k, v [B,Sk,KV,hd], causal, window, q_chunk, kv_chunk,
    q_offset) -> out [B,Sq,H,hd] in q's dtype. Saves (q, k, v, out, lse)
    and nothing of size Sq x Sk."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk, q_offset):
        out, lse = dispatch.flash_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            q_chunk=q_chunk, kv_chunk=kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_chunk, kv_chunk, q_offset)
        return out

    @staticmethod
    def backward(ctx, d_out):
        dq, dk, dv = flash_bwd(*ctx.args, ctx.saved_tensors, d_out)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window, q_chunk: int, kv_chunk: int,
                       q_offset: int) -> torch.Tensor:
    """The chunked path of `models.attention.attention`: Sq % q_chunk ==
    0 and Sk % kv_chunk == 0."""
    check_chunks(q.shape[1], k.shape[1], q_chunk, kv_chunk)
    return FlashAttentionFn.apply(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal, window, q_chunk,
                                  kv_chunk, q_offset)
