"""Sequence-sharded decode attention with the log-sum-exp merge (DESIGN §5).

Mirrors `src/repro/dist/decode.py::flash_decode_seq_sharded` (:30). At
long context the decode step's KV cache outgrows the weights, so each rank
of a group scores a contiguous Smax / n slice of it and the ranks merge:

    m   = MAX_r max(s_r)                    one scalar per (b, head)
    l   = SUM_r Σ exp(s_r − m)
    out = SUM_r (exp(s_r − m) @ v_r) / l

the same fp32 softmax as `models.attention.decode_attention` on the whole
cache, reassociated. Where the reference's `shard_map` views one global
array through `in_specs=P(None, axis)`, every rank here holds the same full
cache and reads its slice [rank · Smax / n, (rank + 1) · Smax / n); the
merge is three all-reduces (`dist.collectives`). It plugs into the serving
engine through `Engine(attn_fn=...)`:

    attn_fn = functools.partial(flash_decode_seq_sharded, group=pg)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist.collectives import (group_rank, group_size, pmax,
                                          psum_no_grad)

NEG_INF = -1e30


def flash_decode_seq_sharded(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, pos: torch.Tensor,
                             group=None, *,
                             window: Optional[int] = None,
                             local: bool = False) -> torch.Tensor:
    """q [B, 1, H, hd]; k/v caches [B, Smax, KV, hd], the same on every
    rank of `group`; pos a scalar or per-slot [B] int tensor. -> [B, 1, H,
    hd] in q's dtype, the same on every rank. Matches `decode_attention(q,
    k, v, pos, window=window)`: entries past `pos` (and outside the
    window) are masked. Smax must divide the group's size. `local=True`:
    the caches are this rank's slice [B, Smax / n, KV, hd] (the model
    axis's sequence-sharded cache, `decode_cache_specs`)."""
    n, r = group_size(group), group_rank(group)
    sliced = local
    smax = k_cache.shape[1] * (n if sliced else 1)
    if smax % n:
        raise ValueError(f"seq len {smax} must divide the group's size {n}")
    local = smax // n
    lo = r * local
    b, _, h, hd = q.shape
    kvh = k_cache.shape[2]
    g = h // kvh
    if sliced:
        k, v = k_cache.float(), v_cache.float()
    else:
        k = k_cache[:, lo:lo + local].float()
        v = v_cache[:, lo:lo + local].float()
    qg = q.reshape(b, 1, kvh, g, hd).float() * hd ** -0.5
    scores = torch.einsum("bqkgh,bmkh->bkgqm", qg, k)       # [b,kv,g,1,L]
    j = lo + torch.arange(local, device=q.device)
    pos_col = torch.as_tensor(pos, device=q.device).reshape(-1, 1)
    ok = j[None, :] <= pos_col
    if window is not None:
        ok &= j[None, :] > pos_col - window
    scores = torch.where(ok[:, None, None, None, :], scores,
                         scores.new_tensor(NEG_INF))
    # pos >= 0 leaves one unmasked column over all ranks, so m is finite
    # and the masked terms vanish
    m = pmax(torch.amax(scores, dim=-1), group)              # [b,kv,g,1]
    p = torch.exp(scores - m[..., None])
    den = psum_no_grad(torch.sum(p, dim=-1), group)
    acc = psum_no_grad(torch.einsum("bkgqm,bmkh->bqkgh", p, v), group)
    out = acc / torch.movedim(den, 3, 1)[..., None]          # [b,1,kv,g,hd]
    return out.reshape(b, 1, h, hd).to(q.dtype)
