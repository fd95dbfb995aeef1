"""GQA attention: the direct path, the chunked path and single-token decode.

Mirrors `src/repro/models/attention.py`: `project_qkv` (:38), the direct
einsum path `_direct_attention` (:70), the `attention` dispatcher (:253) and
`decode_attention` (:273), with the same NEG_INF = -1e30 masking and fp32
scores. The chunked online-softmax path (`_block_mask` :87, `_flash_fwd`
:98, `_flash_bwd` :147, `_flash_attention_xla` :216) lives in
`kernels/flash_attention/`: `ops.FlashAttentionFn`, whose forward is the
hand-written CUDA kernel on the card and `ref.flash_fwd_ref` on the CPU,
and whose backward is the blockwise recompute. The dispatcher takes it
under the reference's rule: a sequence longer than `direct_threshold`
whose lengths are multiples of both chunks. The reference's
`set_impl("autodiff")` switch (:237-250) is not ported (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.models.layers import apply_norm, apply_rope, dense_init, \
    norm_init

NEG_INF = -1e30


def attn_init(gen: torch.Generator, d_model: int, num_heads: int,
              num_kv_heads: int, head_dim: int, qk_norm: bool = False, *,
              device) -> dict:
    p = {
        "wq": dense_init(gen, d_model, num_heads * head_dim, device=device),
        "wk": dense_init(gen, d_model, num_kv_heads * head_dim, device=device),
        "wv": dense_init(gen, d_model, num_kv_heads * head_dim, device=device),
        "wo": dense_init(gen, num_heads * head_dim, d_model, device=device),
    }
    if qk_norm:
        p["q_norm"] = norm_init(head_dim, device=device)
        p["k_norm"] = norm_init(head_dim, device=device)
    return p


def project_qkv(p: dict, x: torch.Tensor, num_heads: int, num_kv_heads: int,
                head_dim: int, cos=None, sin=None, qk_norm: bool = False,
                eps: float = 1e-5):
    """x [B,S,D] -> q [B,S,H,hd], k/v [B,S,KV,hd] with RoPE + optional qk-norm."""
    dt = x.dtype
    b, s, _ = x.shape
    q = (x @ p["wq"].to(dt)).reshape(b, s, num_heads, head_dim)
    k = (x @ p["wk"].to(dt)).reshape(b, s, num_kv_heads, head_dim)
    v = (x @ p["wv"].to(dt)).reshape(b, s, num_kv_heads, head_dim)
    if qk_norm:
        q = apply_norm(p["q_norm"], q, eps=eps)
        k = apply_norm(p["k_norm"], k, eps=eps)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _scores_mask(sq: int, sk: int, q_offset: int, causal: bool,
                 window: int | None, device) -> torch.Tensor | None:
    """Boolean [Sq, Sk] allowed-mask, or None if fully allowed."""
    if not causal and window is None:
        return None
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    kj = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= kj <= qi
    if window is not None:
        ok &= kj > qi - window
    return ok


def _direct_attention(q, k, v, causal: bool, window: int | None,
                      q_offset: int = 0):
    """q [B,Sq,H,hd]; k,v [B,Sk,KV,hd] -> [B,Sq,H,hd]. GQA grouped einsum."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd)
    scale = hd ** -0.5
    scores = torch.einsum("bqkgh,bmkh->bkgqm", qg.float() * scale, k.float())
    mask = _scores_mask(sq, k.shape[1], q_offset, causal, window, q.device)
    if mask is not None:
        scores = torch.where(mask[None, None, None], scores,
                             scores.new_tensor(NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqm,bmkh->bqkgh", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, hd)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              q_offset: int = 0, direct_threshold: int = 1024,
              q_chunk: int = 512, kv_chunk: int = 1024):
    """The reference dispatcher's rule: direct unless the sequence is long
    AND a multiple of both chunk sizes; then the chunked (flash) path, whose
    backward is the blockwise recompute."""
    sq, sk = q.shape[1], k.shape[1]
    if max(sq, sk) <= direct_threshold or sq % q_chunk or sk % kv_chunk:
        return _direct_attention(q, k, v, causal, window, q_offset)
    return flash_attention_op(q, k, v, causal, window, q_chunk, kv_chunk,
                              q_offset)


def decode_attention(q, k_cache, v_cache, pos, *, window: int | None = None):
    """Single-token decode. q [B,1,H,hd]; caches [B,Smax,KV,hd]; pos is a
    per-slot [B] tensor (each serving slot decodes at its own position).

    Masks cache entries beyond `pos` (and outside the sliding window).
    """
    b, _, h, hd = q.shape
    smax, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    qg = q.reshape(b, 1, kv, g, hd).float() * hd ** -0.5
    scores = torch.einsum("bqkgh,bmkh->bkgqm", qg, k_cache.float())
    j = torch.arange(smax, device=q.device)
    pos_col = pos.reshape(-1, 1)                       # [B,1]
    ok = j[None, :] <= pos_col
    if window is not None:
        ok &= j[None, :] > pos_col - window
    scores = torch.where(ok[:, None, None, None, :], scores,
                         scores.new_tensor(NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqm,bmkh->bqkgh", probs.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, hd)
