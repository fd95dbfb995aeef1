"""Decode paths with KV caches and SSM carries: slot-major and paged.

Mirrors `src/repro/models/decode.py` for the `dense` and `ssm` families:
`_ssm_cache` (:52), `init_decode_state` (:79), `_mamba_decode` (:156),
`decode_step` (:164), `prefill` (:314, with its chunk rule :341),
`init_paged_state` (:464), `paged_decode_step` (:502, an ssm state with no
page table passing straight through, :515-517), `reset_slot` (:619) and
`write_prefill` (:642). Layouts are the reference's:
  slot-major  k/v [L, B, Smax, KV, hd]
  paged       k/v [L, P, page, KV, hd] + page_table [B, pages_per_slot]
  ssm         conv_x [L, B, W-1, d_inner], conv_b / conv_c [L, B, W-1, N]
              in the compute dtype, ssm [L, B, H, N, P] fp32, slot-major
              in both (an ssm paged state has no k, v or page table)
with physical page 0 the reserved trash page that inactive slots write into
and that no request ever reads (its entries lie past every mask).

Departure: the KV caches and the SSM carries are updated IN PLACE
(`index_put_` into the pool, `copy_` into the carries), where the
reference returns a new pytree and relies on buffer donation
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
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models.layers import apply_norm, rope_angles
from repro_torch.models.model import (apply_attn_part, apply_ffn_part,
                                      apply_mamba_part, require_ported,
                                      torch_dtype)

SSM_KEYS = ("conv_x", "conv_b", "conv_c", "ssm")


def _ssm_cache(cfg: ModelConfig, n_layers: int, bsz: int, *,
               device) -> dict:
    """`mamba2.mamba2_decode_state`'s carries stacked over `n_layers`."""
    one = mamba_mod.mamba2_decode_state(
        bsz, cfg.d_model, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
        expand=cfg.ssm_expand, conv_width=cfg.ssm_conv_width,
        dtype=torch_dtype(cfg), device="meta")
    return {k: torch.zeros((n_layers, *v.shape), dtype=v.dtype,
                           device=device) for k, v in one.items()}


def _ssm_decode_layers(cfg: ModelConfig, params: dict, token: torch.Tensor,
                       state: dict) -> torch.Tensor:
    """The ssm single-token step: each layer's carries are read from
    `state` and the new ones copied back in place. Returns hidden [B, D]
    (final-normed)."""
    x = params["embed"][token][:, None, :].to(torch_dtype(cfg))  # [B,1,D]
    for li, bp in enumerate(params["blocks"]):
        h = apply_norm(bp["ln1"], x, eps=cfg.norm_eps, kind=cfg.norm)
        y, new = mamba_mod.decode_mamba2(
            bp["mamba"], h, {k: state[k][li] for k in SSM_KEYS},
            d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
            expand=cfg.ssm_expand)
        x = x + y
        for k in SSM_KEYS:
            state[k][li].copy_(new[k])
    x = apply_norm(params["final_norm"], x, eps=cfg.norm_eps, kind=cfg.norm)
    return x[:, 0, :]


def _decode_layers(cfg: ModelConfig, params: dict, token: torch.Tensor,
                   pos: torch.Tensor, kv_at: Callable, window):
    """The dense single-token step. `kv_at(layer, k, v)` stores this step's
    k/v [B, KV, hd] for `layer` and returns the [B, Smax, KV, hd] caches
    the step attends over. Returns hidden [B, D] (final-normed)."""
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
    """Slot-major cache: k/v [L, B, Smax, KV, hd] (dense), or the ssm
    carries."""
    require_ported(cfg)
    if cfg.family == "ssm":
        return _ssm_cache(cfg, cfg.num_layers, bsz, device=device)
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
    An ssm state's carries are stepped in place (pos is not read).
    """
    require_ported(cfg)
    if cfg.family == "ssm":
        return _ssm_decode_layers(cfg, params, token, state), state
    rows = torch.arange(token.shape[0], device=token.device)

    def kv_at(li, k, v):
        state["k"][li, rows, pos] = k.to(state["k"].dtype)
        state["v"][li, rows, pos] = v.to(state["v"].dtype)
        return state["k"][li], state["v"][li]

    return _decode_layers(cfg, params, token, pos, kv_at, window), state


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            window: Optional[int] = None):
    """One batched forward-shaped pass that also emits decode-cache contents.

    tokens [B,S] -> (hidden [B,S,D] final-normed, cache), with the same op
    order as `model.forward`; the cache is {"k","v": [L,B,S,KV,hd]} for
    the dense family and the post-prompt carries {"conv_x", "conv_b",
    "conv_c": [L,B,W-1,*], "ssm": [L,B,H,N,P]} for ssm. The SSD scan needs
    chunk | S: a prompt whose length is not a multiple of `ssm_chunk` runs
    as one chunk of S (the reference's rule).
    """
    require_ported(cfg)
    s = tokens.shape[1]
    dtype = torch_dtype(cfg)
    x = params["embed"][tokens].to(dtype)
    if cfg.family == "ssm":
        chunk = cfg.ssm_chunk if cfg.ssm_chunk and s % cfg.ssm_chunk == 0 \
            else s
        states = []
        for bp in params["blocks"]:
            x, mst = apply_mamba_part(cfg, bp, x, chunk=chunk,
                                      return_state=True)
            states.append(mst)
        x = apply_norm(params["final_norm"], x, eps=cfg.norm_eps,
                       kind=cfg.norm)
        return x, {k: torch.stack([st[k] for st in states])
                   for k in SSM_KEYS}
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
    An ssm state holds only its slot-major carries, no pool.
    """
    require_ported(cfg)
    if cfg.family == "ssm":
        return _ssm_cache(cfg, cfg.num_layers, num_slots, device=device)
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
    A state without a page table (ssm) passes straight to `decode_step`.
    """
    if "page_table" not in state:
        return decode_step(cfg, params, token, pos, state, window=window)
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
    """Zero slot `slot`'s ssm carries, and point its page table back at the
    trash page (paged) or zero its K/V rows (slot-major). Paged K/V pages
    are reclaimed by the pool allocator rather than zeroed: stale contents
    are unreachable because attention masks everything beyond the new
    request's own writes."""
    for name in SSM_KEYS:
        if name in state:
            state[name][:, slot] = 0
    if "page_table" in state:
        state["page_table"][slot] = 0
    elif "k" in state:
        state["k"][:, slot] = 0
        state["v"][:, slot] = 0
    return state


def write_prefill(cfg: ModelConfig, state: dict, cache: dict,
                  slots: torch.Tensor, *, plen: int) -> dict:
    """Write `prefill` cache pieces for slot ids `slots` ([G] int) into a
    paged (or slot-major) state. Paged states must already have pages
    allocated in rows `slots` of the page table (`PagePool.alloc`)."""
    for name in SSM_KEYS:
        if name in cache:
            state[name][:, slots] = cache[name].to(state[name].dtype)
    if "k" not in cache:
        return state
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
