"""Decode paths with KV caches, dense family: slot-major and paged.

Mirrors `src/repro/models/decode.py` for the `dense` family:
`decode_step` (:164), `prefill` (:314), `init_paged_state` (:464),
`paged_decode_step` (:502), `reset_slot` (:619) and `write_prefill` (:642).
Layouts are the reference's:
  slot-major  k/v [L, B, Smax, KV, hd]
  paged       k/v [L, P, page, KV, hd] + page_table [B, pages_per_slot]
with physical page 0 the reserved trash page that inactive slots write into
and that no request ever reads (its entries lie past every mask).

Departure: the KV caches are updated IN PLACE (`index_put_` into the pool),
where the reference returns a new pytree and relies on buffer donation
(`serve/engine.py:241`) to alias it. The functions still return the state
so call sites read like the reference's. The paged step also writes each
layer's new K/V into the pool before gathering that layer's page view,
instead of gathering all layers, writing the view and scattering back:
the same values are attended either way.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import apply_norm, rope_angles
from repro_torch.models.model import (_require_dense, apply_attn_part,
                                      apply_ffn_part, torch_dtype)


def _decode_layers(cfg: ModelConfig, params: dict, token: torch.Tensor,
                   pos: torch.Tensor, kv_at: Callable, window):
    """The dense single-token step. `kv_at(layer, k, v)` stores this step's
    k/v [B, KV, hd] for `layer` and returns the [B, Smax, KV, hd] caches
    the step attends over. Returns hidden [B, D] (final-normed)."""
    _require_dense(cfg)
    x = params["embed"][token][:, None, :].to(torch_dtype(cfg))  # [B,1,D]
    hd = cfg.resolved_head_dim
    cos, sin = rope_angles(pos[:, None], hd, cfg.rope_theta)
    b = x.shape[0]
    for li, bp in enumerate(params["blocks"]):
        h = apply_norm(bp["ln1"], x, eps=cfg.norm_eps, kind=cfg.norm)
        q, k, v = attn_mod.project_qkv(bp["attn"], h, cfg.num_heads,
                                       cfg.num_kv_heads, hd, cos, sin,
                                       cfg.qk_norm, cfg.norm_eps)
        kc, vc = kv_at(li, k[:, 0], v[:, 0])
        o = attn_mod.decode_attention(q, kc, vc, pos, window=window)
        x = x + o.reshape(b, 1, -1) @ bp["attn"]["wo"].to(x.dtype)
        x = apply_ffn_part(cfg, bp, x)
    x = apply_norm(params["final_norm"], x, eps=cfg.norm_eps, kind=cfg.norm)
    return x[:, 0, :]


def init_decode_state(cfg: ModelConfig, bsz: int, max_seq: int, *,
                      device) -> dict:
    """Slot-major dense cache: k/v [L, B, Smax, KV, hd]."""
    _require_dense(cfg)
    shape = (cfg.num_layers, bsz, max_seq, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dt = torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                pos: torch.Tensor, state: dict, *,
                window: Optional[int] = None):
    """token [B] int, pos per-slot [B] int -> (hidden [B,D], state).

    Slot b writes its cache at its own position pos[b] and attends only to
    its own prefix — batch composition never changes a slot's arithmetic.
    """
    rows = torch.arange(token.shape[0], device=token.device)

    def kv_at(li, k, v):
        state["k"][li, rows, pos] = k.to(state["k"].dtype)
        state["v"][li, rows, pos] = v.to(state["v"].dtype)
        return state["k"][li], state["v"][li]

    return _decode_layers(cfg, params, token, pos, kv_at, window), state


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            window: Optional[int] = None):
    """One batched forward-shaped pass that also emits decode-cache contents.

    tokens [B,S] -> (hidden [B,S,D] final-normed, {"k","v": [L,B,S,KV,hd]}),
    with the same op order as `model.forward`.
    """
    _require_dense(cfg)
    s = tokens.shape[1]
    dtype = torch_dtype(cfg)
    x = params["embed"][tokens].to(dtype)
    cos, sin = rope_angles(torch.arange(s, device=tokens.device),
                           cfg.resolved_head_dim, cfg.rope_theta)
    ks, vs = [], []
    for bp in params["blocks"]:
        x, k, v = apply_attn_part(cfg, bp, x, cos, sin, window=window)
        x = apply_ffn_part(cfg, bp, x)
        ks.append(k.to(dtype))
        vs.append(v.to(dtype))
    x = apply_norm(params["final_norm"], x, eps=cfg.norm_eps, kind=cfg.norm)
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}


# ===========================================================================
# paged cache layout
# ===========================================================================

def init_paged_state(cfg: ModelConfig, num_slots: int, num_pages: int,
                     page_size: int, pages_per_slot: int, *,
                     device) -> dict:
    """K/V live in a shared physical page pool [L, P, page, KV, hd]
    addressed through per-slot page tables [num_slots, pages_per_slot].
    Physical page 0 is the trash page (`serve.kv_pool.PagePool` never
    allocates it); unallocated and inactive page-table entries point at it.
    """
    _require_dense(cfg)
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dt = torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "page_table": torch.zeros((num_slots, pages_per_slot),
                                      dtype=torch.long, device=device)}


def paged_decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                      pos: torch.Tensor, state: dict, *,
                      window: Optional[int] = None):
    """`decode_step` against the paged layout. pos: per-slot [B].

    Per layer: write the slot's new K/V at (page_table[b, pos // page],
    pos % page) of the pool, then gather the slot's pages into a
    logically-contiguous [B, Smax, KV, hd] view and attend. Inactive slots
    (page table pointing at the trash page, pos 0) write trash offset 0.
    """
    pt = state["page_table"]                       # [B, np]
    pool_k, pool_v = state["k"], state["v"]        # [L, P, page, KV, hd]
    _, _, page, kvh, hd = pool_k.shape
    b, npages = pt.shape
    rows = torch.arange(b, device=pt.device)
    phys, off = pt[rows, pos // page], pos % page

    def kv_at(li, k, v):
        pool_k[li, phys, off] = k.to(pool_k.dtype)
        pool_v[li, phys, off] = v.to(pool_v.dtype)
        return (pool_k[li][pt].reshape(b, npages * page, kvh, hd),
                pool_v[li][pt].reshape(b, npages * page, kvh, hd))

    return _decode_layers(cfg, params, token, pos, kv_at, window), state


def reset_slot(state: dict, slot: int) -> dict:
    """Point slot `slot`'s page table back at the trash page (paged), or
    zero its rows (slot-major). Paged K/V pages are reclaimed by the pool
    allocator rather than zeroed: stale contents are unreachable because
    attention masks everything beyond the new request's own writes."""
    if "page_table" in state:
        state["page_table"][slot] = 0
    else:
        state["k"][:, slot] = 0
        state["v"][:, slot] = 0
    return state


def write_prefill(cfg: ModelConfig, state: dict, cache: dict,
                  slots: torch.Tensor, *, plen: int) -> dict:
    """Write `prefill` cache pieces for slot ids `slots` ([G] int) into a
    paged (or slot-major) state. Paged states must already have pages
    allocated in rows `slots` of the page table (`PagePool.alloc`)."""
    if "page_table" in state:
        page = state["k"].shape[2]
        npages = -(-plen // page)
        pt = state["page_table"][slots, :npages]             # [G, npages]
        pad = npages * page - plen
        for name in ("k", "v"):
            raw = cache[name].to(state[name].dtype)           # [L,G,S,KV,hd]
            if pad:
                raw = torch.nn.functional.pad(raw, (0, 0, 0, 0, 0, pad))
            l, g = raw.shape[:2]
            state[name][:, pt] = raw.reshape(l, g, npages, page,
                                             *raw.shape[3:])
    else:
        for name in ("k", "v"):
            state[name][:, slots, :plen] = cache[name].to(state[name].dtype)
    return state
