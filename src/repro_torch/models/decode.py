"""Decode paths with KV caches and SSM carries: slot-major and paged.

Mirrors `src/repro/models/decode.py` for every family: `_ssm_cache`
(:52), `_cross_kv` (:66), `init_decode_state` (:79), `_cross_attn_decode`
(:138), `_mamba_decode` (:156), `decode_step` (:164: dense / moe, ssm,
the hybrid's ring attention over `shared_k/v` masked by `slot_pos`
:207-261, vlm :263-287, audio :289-302), `prefill` (:314, with its chunk
rule :341), `init_paged_state` (:464), `paged_decode_step` (:502, a state
with no page table, ssm and hybrid, passing straight through,
:515-517), `chunk_prefill_step` (:540-616, the dense and moe families),
`reset_slot` (:619) and `write_prefill` (:642, the hybrid ring packing
:676-689). Layouts are the reference's:
  slot-major  k/v [L, B, Smax, KV, hd]
  paged       k/v [L, P, page, KV, hd] + page_table [B, pages_per_slot]
  ssm         conv_x [L, B, W-1, d_inner], conv_b / conv_c [L, B, W-1, N]
              in the compute dtype, ssm [L, B, H, N, P] fp32, slot-major
              in both (an ssm or hybrid paged state has no k, v or page
              table)
  hybrid      + shared_k/v [A, B, Wring, KV, hd] (A applications of the
              shared block, Wring = min(max_seq, window or max_seq)) and
              slot_pos [B, Wring], each ring entry's absolute position
              (-1: empty), slot-major in both
  vlm         + cross_k/v [n_cross, B, Ni, KV, hd] over the image
              embeddings, slot-major in both
  audio       + cross_k/v [L, B, Senc, KV, hd] over the encoder's output,
              slot-major in both
with physical page 0 the reserved trash page that inactive slots write into
and that no request ever reads (its entries lie past every mask).

Under the model axis (`dist.tensor_parallel`) every piece is the rank's
part as `dist.sharding.decode_cache_specs` cuts it: K/V caches, the
hybrid ring and the cross K/V hold the rank's KV heads, or a slot-major
K/V cache and the cross K/V (the vlm's at tp 16) its slice of the
sequence, merged over the ranks (`dist.decode.flash_decode_seq_sharded`);
the ssm carries hold its conv_x columns and ssm heads, conv_b / conv_c
whole (reference `src/repro/dist/sharding.py:240-307`).

`decode_step` and `paged_decode_step` take the reference's `attn_fn`
hook (:118-133, :165, :504): `attn_fn(q, kc, vc, pos, window=...)`
replaces `decode_attention` in the self-attention of the dense, moe, vlm
and audio families, e.g. `dist.decode.flash_decode_seq_sharded` bound to a
process group. As in the reference, the hybrid's ring attention, the
cross-attention and the prefill paths take no hook.

Departure: the KV caches and the SSM carries are updated IN PLACE
(`index_put_` into the pool, `copy_` into the carries), where the
reference returns a new pytree and relies on buffer donation
(`serve/engine.py:241`) to alias it. The functions still return the state
so call sites read like the reference's. The paged step also writes each
layer's new K/V into the pool before gathering that layer's page view,
instead of gathering all layers, writing the view and scattering back:
the same values are attended either way. `chunk_prefill_step` does the
same per layer (the reference scans all layers over a gathered
[L, B, Smax, KV, hd] view). Further departures:
  - `paged_decode_step(active=...)` routes the writes of inactive slots to
    the trash page. The reference's decode wave packs a slot that is
    still prefilling in chunks at position 0 (`serve/engine.py:651-668`)
    and so writes a garbage row into position 0 of its first page, which
    may be a prefix-cache page another request reads;
  - in `chunk_prefill_step` an invalid row (past a slot's `length`) is
    written to the trash page only, so it is absent from the view the
    valid rows attend over (the reference writes it into the view too).
    Valid rows never attend to it (it lies past them), so their hidden
    states are unchanged; an invalid row's own hidden is not the
    reference's, and no caller reads it. In a moe chunk it still takes
    part in its row's dispatch, but it comes after every valid token of
    the row in the stable sort, so it can take only capacity that no
    valid token wanted: the valid rows' outputs are unchanged too;
  - the paged vlm cache holds one cross K/V per cross-attention block,
    cross_k/v [n_cross, slots, Ni, KV, hd], as `init_decode_state` and
    `prefill` build them. The reference's `init_paged_state` sizes them
    by `num_layers` (:491-494), so its `write_prefill` cannot broadcast
    the [n_cross, B, ...] pieces of a model with two or more cross blocks
    (ROADMAP Queue 3 fact f).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

import functools

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.decode import flash_decode_seq_sharded
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models.layers import apply_norm, rope_angles
from repro_torch.models.model import (apply_attn_part, apply_cross_part,
                                      apply_ffn_part, apply_mamba_part,
                                      attn_proj,
                                      apply_shared_attn, cross_kv, cross_out,
                                      cross_q,
                                      encode, num_cross_blocks,
                                      num_shared_apps, shared_attn_mlp,
                                      torch_dtype)

SSM_KEYS = ("conv_x", "conv_b", "conv_c", "ssm")
#: per-slot state pieces written whole at admission and zeroed at reset
SLOT_KEYS = SSM_KEYS + ("shared_k", "shared_v", "cross_k", "cross_v")
#: The flash forward's tile (`flash_attention_block()` and
#: `flash_attention_max_hd()` of `kernels/flash_attention/csrc/
#: flash_attention.cu`): a prefill chunk takes the kernel when the chunk
#: is a multiple of the tile and hd fits it.
FLASH_TILE, FLASH_MAX_HD = 128, 128
ATTN_FAMILIES = ("dense", "moe", "vlm", "audio")   # a self-attention cache


def _ssm_cache(cfg: ModelConfig, n_layers: int, bsz: int, *,
               device) -> dict:
    """`mamba2.mamba2_decode_state`'s carries stacked over `n_layers`."""
    one = mamba_mod.mamba2_decode_state(
        bsz, cfg.d_model, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
        expand=cfg.ssm_expand, conv_width=cfg.ssm_conv_width,
        dtype=torch_dtype(cfg), device="meta")
    return {k: torch.zeros((n_layers, *v.shape), dtype=v.dtype,
                           device=device) for k, v in one.items()}


def _ring(cfg: ModelConfig, bsz: int, max_seq: int, window, *,
          device) -> dict:
    """The hybrid's ring cache of its shared block: [A, B, Wring, KV, hd]
    and each entry's absolute position, -1 while empty. Under the model
    axis the rank's KV heads ('heads' layout) or all of them; a ring whose
    KV heads do not divide tp while Wring does (`decode_cache_specs` would
    split its sequence; no config of `configs/` at tp 2 or 16) is
    refused."""
    wring = min(max_seq, window or max_seq)
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if tp.seq_sharded_cache(kvh, wring):
        raise NotImplementedError(
            f"the hybrid ring split over its sequence ({kvh} KV heads at tp "
            f"{tp.tp_size()})")
    shape = (num_shared_apps(cfg), bsz, wring, tp.local_kv_heads(h, kvh, hd),
             hd)
    dt = torch_dtype(cfg)
    return {"shared_k": torch.zeros(shape, dtype=dt, device=device),
            "shared_v": torch.zeros(shape, dtype=dt, device=device),
            "slot_pos": torch.full((bsz, wring), -1, dtype=torch.long,
                                   device=device)}


def _cross_len(cfg: ModelConfig) -> int:
    """The media's length: the vlm's image tokens, whisper's frames."""
    return cfg.num_image_tokens if cfg.family == "vlm" else cfg.encoder_seq


def _cross_split(cfg: ModelConfig) -> bool:
    """Whether the model ranks hold sequence slices of the cross K/V
    (`decode_cache_specs`: KV heads that do not divide tp, a media length
    that does; the vlm's 1600 image tokens at tp 16)."""
    return tp.seq_sharded_cache(cfg.num_kv_heads, _cross_len(cfg))


def media_kv(cfg: ModelConfig, params: dict, *, image_emb=None,
             frames=None) -> dict:
    """The read-only cross K/V (reference `_cross_kv`): vlm over the image
    embeddings, one per cross block [n_cross, B, Ni, KV, hd]; audio over
    the encoder's output, one per decoder layer [L, B, Senc, KV, hd].
    Under the model axis the rank's KV heads, or its slice of the media's
    sequence (`_cross_split`)."""
    if cfg.family == "vlm":
        return _cross_cache(cfg, [cb["xattn"] for cb in
                                  params["cross_blocks"]],
                            image_emb.to(torch_dtype(cfg)))
    return _cross_cache(cfg, [bp["xattn"] for bp in params["blocks"]],
                        encode(cfg, params["encoder"], frames))


def _cross_cache(cfg: ModelConfig, aps: list, src: torch.Tensor) -> dict:
    ks, vs = zip(*(cross_kv(cfg, ap, src) for ap in aps))
    out = {"cross_k": torch.stack(ks), "cross_v": torch.stack(vs)}
    if _cross_split(cfg):
        n = src.shape[1]
        if n != _cross_len(cfg):
            raise ValueError(f"media of {n} positions, the config's "
                             f"{_cross_len(cfg)}")
        out = {k: tp.own_slice(v, n, dim=2).contiguous()
               for k, v in out.items()}
    return out


def _cross_decode(cfg: ModelConfig, bp: dict, x: torch.Tensor, xk, xv, *,
                  gated: bool) -> torch.Tensor:
    """Cross-attention of one token x [B,1,D] against precomputed
    xk / xv [B, Ssrc, KV, hd] (reference `_cross_attn_decode`); a
    sequence slice of them (`_cross_split`) merged over the model ranks
    (`flash_decode_seq_sharded`, every position allowed)."""
    h = apply_norm(bp["ln1"] if gated else bp["ln_x"], x, eps=cfg.norm_eps,
                   kind=cfg.norm)
    b = x.shape[0]
    q = cross_q(cfg, bp["xattn"], h)
    split = _cross_split(cfg)
    n = _cross_len(cfg) if split else xk.shape[1]
    last = torch.full((b,), n - 1, dtype=torch.long, device=x.device)
    if split:
        o = flash_decode_seq_sharded(q, xk, xv, last, tp.model_group(),
                                     local=True)
    else:
        o = attn_mod.decode_attention(q, xk, xv, last)
    return cross_out(cfg, bp, x, o.reshape(b, 1, -1), gated=gated)


def _masked_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                      ok: torch.Tensor) -> torch.Tensor:
    """The reference's masked fp32 attention of C queries a slot over its
    keys: q [B, C, H, hd], kc / vc [B, Smax, KV, hd], ok [B, C, Smax]."""
    b, c, h, hd = q.shape
    kvh = kc.shape[2]
    qg = q.reshape(b, c, kvh, h // kvh, hd).float() * hd ** -0.5
    scores = torch.einsum("bqkgh,bmkh->bkgqm", qg, kc.float())
    scores = torch.where(ok[:, None, None], scores,
                         scores.new_tensor(attn_mod.NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqm,bmkh->bqkgh", probs.to(vc.dtype), vc)
    return o.reshape(b, c, h, hd)


def _ssm_decode_layers(cfg: ModelConfig, params: dict, token: torch.Tensor,
                       pos: torch.Tensor, state: dict, window) -> torch.Tensor:
    """The ssm and hybrid single-token step: each layer's carries are read
    from `state` and the new ones copied back in place; the hybrid's shared
    block writes its ring entry pos % Wring and attends over the ring
    entries whose positions lie in [pos - window, pos]. Returns hidden
    [B, D] (final-normed)."""
    x = tp.table_rows(params["embed"], token, cfg.padded_vocab)[:, None, :].to(
        torch_dtype(cfg))  # [B,1,D]
    hybrid = cfg.family == "hybrid"
    if hybrid:
        sp, every = params["shared_attn"], cfg.hybrid_attn_every
        hd = cfg.resolved_head_dim
        cos, sin = rope_angles(pos[:, None], hd, cfg.rope_theta)
        rows = torch.arange(token.shape[0], device=token.device)
        slot_pos = state["slot_pos"]
        ring = pos % slot_pos.shape[1]
        slot_pos[rows, ring] = pos
        ok = (slot_pos >= 0) & (slot_pos <= pos[:, None])
        if window is not None:
            ok &= slot_pos > pos[:, None] - window
    for li, bp in enumerate(params["blocks"]):
        h = apply_norm(bp["ln1"], x, eps=cfg.norm_eps, kind=cfg.norm)
        y, new = mamba_mod.decode_mamba2(
            bp["mamba"], h, {k: state[k][li] for k in SSM_KEYS},
            d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
            expand=cfg.ssm_expand)
        x = x + y
        for k in SSM_KEYS:
            state[k][li].copy_(new[k])
        if hybrid and li % every == every - 1:
            a = li // every
            h = apply_norm(sp["ln1"], x, eps=cfg.norm_eps, kind=cfg.norm)
            q, k, v = attn_mod.project_qkv(sp["attn"], h, cfg.num_heads,
                                           cfg.num_kv_heads, hd, cos, sin)
            sk, sv = state["shared_k"][a], state["shared_v"][a]
            sk[rows, ring] = k[:, 0].to(sk.dtype)
            sv[rows, ring] = v[:, 0].to(sv.dtype)
            o = _masked_attention(q, sk, sv, ok[:, None])
            x = shared_attn_mlp(cfg, sp, x, o.reshape(x.shape[0], 1, -1))
    x = apply_norm(params["final_norm"], x, eps=cfg.norm_eps, kind=cfg.norm)
    return x[:, 0, :]


def _decode_layers(cfg: ModelConfig, params: dict, token: torch.Tensor,
                   pos: torch.Tensor, kv_at: Callable, window,
                   state: dict, attn_fn: Optional[Callable] = None):
    """The single-token step of the attention families. `kv_at(layer, k,
    v)` stores this step's k/v [B, KV, hd] for `layer` and returns the
    [B, Smax, KV, hd] caches the step attends over; the vlm and audio
    cross-attention read `state`'s cross_k/v. `attn_fn` (default
    `decode_attention`) attends over those caches. Returns hidden [B, D]
    (final-normed)."""
    attend = attn_fn or attn_mod.decode_attention
    x = tp.table_rows(params["embed"], token, cfg.padded_vocab)[:, None, :].to(
        torch_dtype(cfg))  # [B,1,D]
    hd = cfg.resolved_head_dim
    cos, sin = rope_angles(pos[:, None], hd, cfg.rope_theta)
    b = x.shape[0]
    fam = cfg.family
    if fam not in ("dense", "moe"):
        window = None                      # vlm / audio: no window
    for li, bp in enumerate(params["blocks"]):
        h = apply_norm(bp["ln1"], x, eps=cfg.norm_eps, kind=cfg.norm)
        q, k, v = attn_mod.project_qkv(bp["attn"], h, cfg.num_heads,
                                       cfg.num_kv_heads, hd, cos, sin,
                                       cfg.qk_norm, cfg.norm_eps)
        kc, vc = kv_at(li, k[:, 0], v[:, 0])
        o = attend(q, kc, vc, pos, window=window)
        x = x + attn_proj(cfg, bp["attn"], o.reshape(b, 1, -1), x.dtype)
        if fam == "audio":
            x = _cross_decode(cfg, bp, x, state["cross_k"][li],
                              state["cross_v"][li], gated=False)
        x, _ = apply_ffn_part(cfg, bp, x)
        every = cfg.cross_attn_every
        if fam == "vlm" and li % every == every - 1:
            ci = li // every
            x = _cross_decode(cfg, params["cross_blocks"][ci], x,
                              state["cross_k"][ci], state["cross_v"][ci],
                              gated=True)
    x = apply_norm(params["final_norm"], x, eps=cfg.norm_eps, kind=cfg.norm)
    return x[:, 0, :]


def init_decode_state(cfg: ModelConfig, bsz: int, max_seq: int, *,
                      device, params: Optional[dict] = None,
                      image_emb: Optional[torch.Tensor] = None,
                      frames: Optional[torch.Tensor] = None,
                      window: Optional[int] = None) -> dict:
    """Slot-major cache: k/v [L, B, Smax, KV, hd] (attention families),
    the ssm carries (ssm, hybrid), the hybrid's ring (Wring = min(max_seq,
    window or max_seq)), and for vlm / audio the cross K/V of `params`
    over `image_emb` [B, Ni, D] / `frames` [B, Senc, D]."""
    fam = cfg.family
    state: dict = {}
    dt = torch_dtype(cfg)
    if fam in ATTN_FAMILIES:
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        seq = max_seq
        if tp.seq_sharded_cache(kvh, max_seq):
            seq = max_seq // tp.tp_size()
        shape = (cfg.num_layers, bsz, seq, tp.local_kv_heads(h, kvh, hd),
                 hd)
        state["k"] = torch.zeros(shape, dtype=dt, device=device)
        state["v"] = torch.zeros(shape, dtype=dt, device=device)
    if fam in ("ssm", "hybrid"):
        state.update(_ssm_cache(cfg, cfg.num_layers, bsz, device=device))
    if fam == "hybrid":
        state.update(_ring(cfg, bsz, max_seq, window, device=device))
    if fam in ("vlm", "audio"):
        state.update(media_kv(cfg, params, image_emb=image_emb,
                              frames=frames))
    return state


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                pos: torch.Tensor, state: dict, *,
                window: Optional[int] = None,
                attn_fn: Optional[Callable] = None):
    """token [B] int, pos per-slot [B] int -> (hidden [B,D], state).

    Slot b writes its cache at its own position pos[b] and attends only to
    its own prefix — batch composition never changes a slot's arithmetic.
    An ssm state's carries are stepped in place; a hybrid state's ring
    entry pos % Wring too.
    """
    if cfg.family in ("ssm", "hybrid"):
        return _ssm_decode_layers(cfg, params, token, pos, state,
                                  window), state
    rows = torch.arange(token.shape[0], device=token.device)
    local = state["k"].shape[2]
    if tp.seq_sharded_cache(cfg.num_kv_heads, local * tp.tp_size()):
        # the model ranks hold contiguous sequence slices of the cache
        # (`decode_cache_specs`); the owner of pos writes it, and the
        # attention merges the slices (`flash_decode_seq_sharded`)
        lo = tp.tp_rank() * local
        own = ((pos >= lo) & (pos < lo + local))[:, None, None]
        at = torch.clamp(pos - lo, 0, local - 1)

        def kv_at(li, k, v):
            for name, new in (("k", k), ("v", v)):
                c = state[name]
                c[li, rows, at] = torch.where(own, new.to(c.dtype),
                                              c[li, rows, at])
            return state["k"][li], state["v"][li]

        if attn_fn is None:
            attn_fn = functools.partial(flash_decode_seq_sharded,
                                        group=tp.model_group(), local=True)
    else:
        def kv_at(li, k, v):
            state["k"][li, rows, pos] = k.to(state["k"].dtype)
            state["v"][li, rows, pos] = v.to(state["v"].dtype)
            return state["k"][li], state["v"][li]

    return _decode_layers(cfg, params, token, pos, kv_at, window,
                          state, attn_fn), state


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            window: Optional[int] = None,
            image_emb: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None):
    """One batched forward-shaped pass that also emits decode-cache contents.

    tokens [B,S] -> (hidden [B,S,D] final-normed, cache), with the same op
    order as `model.forward`; the cache is
      attention families  k, v [L,B,S,KV,hd]
      ssm, hybrid         the post-prompt carries {"conv_x", "conv_b",
                          "conv_c": [L,B,W-1,*], "ssm": [L,B,H,N,P]}
      hybrid              + shared_k/v [A,B,S,KV,hd], the shared block's
                          raw K/V per application (`write_prefill` packs
                          the ring)
      vlm, audio          + cross_k/v as `init_decode_state` builds them.
    The SSD scan needs chunk | S: a prompt whose length is not a multiple
    of `ssm_chunk` runs as one chunk of S (the reference's rule).
    """
    fam = cfg.family
    s = tokens.shape[1]
    dtype = torch_dtype(cfg)
    x = tp.table_rows(params["embed"], tokens, cfg.padded_vocab).to(dtype)
    cache: dict = {}
    if fam != "ssm":
        cos, sin = rope_angles(torch.arange(s, device=tokens.device),
                               cfg.resolved_head_dim, cfg.rope_theta)
    if fam in ("ssm", "hybrid"):
        chunk = cfg.ssm_chunk if cfg.ssm_chunk and s % cfg.ssm_chunk == 0 \
            else s
        states, ks, vs = [], [], []
        every = cfg.hybrid_attn_every
        for li, bp in enumerate(params["blocks"]):
            x, mst = apply_mamba_part(cfg, bp, x, chunk=chunk,
                                      return_state=True)
            states.append(mst)
            if fam == "hybrid" and li % every == every - 1:
                x, k, v = apply_shared_attn(cfg, params["shared_attn"], x,
                                            cos, sin, window)
                ks.append(k.to(dtype))
                vs.append(v.to(dtype))
        cache.update({k: torch.stack([st[k] for st in states])
                      for k in SSM_KEYS})
        if fam == "hybrid":
            cache["shared_k"], cache["shared_v"] = torch.stack(ks), \
                torch.stack(vs)
    else:
        media = {}
        if fam == "vlm":
            media = media_kv(cfg, params, image_emb=image_emb)
        if fam == "audio":
            enc_out = encode(cfg, params["encoder"], frames)
            media = _cross_cache(cfg, [bp["xattn"] for bp in
                                       params["blocks"]], enc_out)
        win = window if fam in ("dense", "moe") else None
        ks, vs = [], []
        every = cfg.cross_attn_every
        for li, bp in enumerate(params["blocks"]):
            x, k, v = apply_attn_part(cfg, bp, x, cos, sin, window=win)
            if fam == "audio":
                x = apply_cross_part(cfg, bp, x, enc_out)
            x, _ = apply_ffn_part(cfg, bp, x)
            if fam == "vlm" and li % every == every - 1:
                x = apply_cross_part(cfg, params["cross_blocks"][li // every],
                                     x, image_emb, gated=True)
            ks.append(k.to(dtype))
            vs.append(v.to(dtype))
        cache["k"], cache["v"] = torch.stack(ks), torch.stack(vs)
        cache.update(media)
    x = apply_norm(params["final_norm"], x, eps=cfg.norm_eps, kind=cfg.norm)
    return x, cache


# ===========================================================================
# paged cache layout
# ===========================================================================

def init_paged_state(cfg: ModelConfig, num_slots: int, num_pages: int,
                     page_size: int, pages_per_slot: int, *,
                     device, window: Optional[int] = None) -> dict:
    """Attention K/V live in a shared physical page pool [L, P, page, KV,
    hd] addressed through per-slot page tables [num_slots,
    pages_per_slot]. Physical page 0 is the trash page
    (`serve.kv_pool.PagePool` never allocates it); unallocated and
    inactive page-table entries point at it. Everything O(1) a slot stays
    slot-major: the ssm carries, the hybrid ring (Wring = min(max_seq,
    window or max_seq)) and the vlm / audio cross K/V, zero until
    `write_prefill` fills them; the vlm's one a cross block (see the
    module docstring). An ssm or hybrid state has no pool.
    """
    fam = cfg.family
    dt = torch_dtype(cfg)
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    state: dict = {}
    if fam in ATTN_FAMILIES:
        if tp.head_layout(cfg.num_heads, kvh, hd) not in ("heads",
                                                         "replicated"):
            raise NotImplementedError(
                f"the paged pool under tensor parallelism needs the heads "
                f"to divide tp ({cfg.num_heads} / {kvh} heads at tp "
                f"{tp.tp_size()}); the slot-major decode_step shards the "
                f"sequence instead")
        kvh = tp.local_kv_heads(cfg.num_heads, kvh, hd)
        shape = (cfg.num_layers, num_pages, page_size, kvh, hd)
        state["k"] = torch.zeros(shape, dtype=dt, device=device)
        state["v"] = torch.zeros(shape, dtype=dt, device=device)
        state["page_table"] = torch.zeros((num_slots, pages_per_slot),
                                          dtype=torch.long, device=device)
    if fam in ("ssm", "hybrid"):
        state.update(_ssm_cache(cfg, cfg.num_layers, num_slots,
                                device=device))
    if fam == "hybrid":
        state.update(_ring(cfg, num_slots, pages_per_slot * page_size,
                           window, device=device))
    if fam in ("vlm", "audio"):
        n, src = ((num_cross_blocks(cfg), cfg.num_image_tokens)
                  if fam == "vlm" else (cfg.num_layers, cfg.encoder_seq))
        shape = (n, num_slots, src, kvh, hd)
        state["cross_k"] = torch.zeros(shape, dtype=dt, device=device)
        state["cross_v"] = torch.zeros(shape, dtype=dt, device=device)
    return state


def paged_decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                      pos: torch.Tensor, state: dict, *,
                      window: Optional[int] = None,
                      active: Optional[torch.Tensor] = None,
                      attn_fn: Optional[Callable] = None):
    """`decode_step` against the paged layout. pos: per-slot [B].

    Per layer: write the slot's new K/V at (page_table[b, pos // page],
    pos % page) of the pool, then gather the slot's pages into a
    logically-contiguous [B, Smax, KV, hd] view and attend. A slot with
    `active[b]` False (or, without `active`, a page table pointing at the
    trash page and pos 0) writes trash offset 0 and nothing of its own.
    A state without a page table (ssm, hybrid) passes straight to
    `decode_step`.
    """
    if "page_table" not in state:
        return decode_step(cfg, params, token, pos, state, window=window,
                           attn_fn=attn_fn)
    pt = state["page_table"]                       # [B, np]
    pool_k, pool_v = state["k"], state["v"]        # [L, P, page, KV, hd]
    _, _, page, kvh, hd = pool_k.shape
    b, npages = pt.shape
    rows = torch.arange(b, device=pt.device)
    phys, off = pt[rows, pos // page], pos % page
    if active is not None:
        phys, off = torch.where(active, phys, 0), torch.where(active, off, 0)

    def kv_at(li, k, v):
        pool_k[li, phys, off] = k.to(pool_k.dtype)
        pool_v[li, phys, off] = v.to(pool_v.dtype)
        return (pool_k[li][pt].reshape(b, npages * page, kvh, hd),
                pool_v[li][pt].reshape(b, npages * page, kvh, hd))

    return _decode_layers(cfg, params, token, pos, kv_at, window,
                          state, attn_fn), state


def _flash_chunk(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                 pages: torch.Tensor, q_offset: int, window) -> torch.Tensor:
    """One slot's chunk through the flash forward: q [1, C, H, hd] at
    absolute offset `q_offset`, against the slot's pages `pages` [np] of
    one layer's pool [P, page, KV, hd], cut (or zero-padded) to the
    smallest multiple of FLASH_TILE that covers q_offset + C. The causal
    mask keeps every key past the chunk out, whatever it holds."""
    page, kvh, hd = pool_k.shape[1:]
    c = q.shape[1]
    sk = -(-(q_offset + c) // FLASH_TILE) * FLASH_TILE
    n = min(pages.shape[0], -(-sk // page))

    def view(pool):
        x = pool[pages[:n]].reshape(1, n * page, kvh, hd)
        if n * page >= sk:
            return x[:, :sk]
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, sk - n * page))

    return flash_attention_op(q, view(pool_k), view(pool_v), True, window,
                              c, FLASH_TILE, q_offset)


def chunk_prefill_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                       start: torch.Tensor, length: torch.Tensor,
                       state: dict, *, window: Optional[int] = None,
                       solo: Optional[tuple[int, int]] = None):
    """Prefill one page-aligned chunk per slot against the paged layout.
    tokens [B, C]; start [B] absolute position of tokens[:, 0]; length [B]
    valid token count this wave (0 = slot idle). Returns (hidden [B, C, D]
    final-normed, state); only valid rows of hidden are defined.

    Queries carry their absolute positions (RoPE, causal and window mask).
    Per layer, the valid (slot, position) rows write their K/V into the
    pool in place (invalid rows: the trash page, offset 0), then the chunk
    attends over its slots' gathered page views: the cached prefix plus
    itself. Masked scores contribute exact zeros, so a position's
    arithmetic depends only on the tokens at and before it, never on which
    physical pages hold the prefix: a prefix-cache hit resumed on the
    absolute chunk grid is bitwise the cold run.

    `solo = (slot, start)` says that `slot` alone has length > 0, at host
    position `start` (a chunk wave of the engine). Where the flash kernel
    takes the shapes (C a multiple of FLASH_TILE, hd <= FLASH_MAX_HD), that
    slot's attention goes through `flash_attention_op` with q_offset =
    start over its own pages, and the other rows attend to nothing (zeros;
    they are invalid). On the CPU the op runs its plain version. A
    speculative verify pass (C = k) passes no `solo` and stays plain.
    The dense and moe families only: ssm and hybrid carry sequential state
    that cannot resume mid-prompt, and vlm and audio prefill through the
    batched path (ValueError, as the reference). A moe row dispatches its
    C tokens alone, at capacity(C): chunked and whole-prompt runs agree
    where no capacity binds.
    """
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"chunked prefill supports the dense and moe "
                         f"families, not {cfg.family}")
    b, c = tokens.shape
    dev = tokens.device
    hd = cfg.resolved_head_dim
    pt = state["page_table"]                       # [B, np]
    pool_k, pool_v = state["k"], state["v"]        # [L, P, page, KV, hd]
    page, kvh = pool_k.shape[2], pool_k.shape[3]
    npages = pt.shape[1]
    smax = npages * page
    rows = torch.arange(b, device=dev)
    col = torch.arange(c, device=dev)
    positions = start[:, None] + col[None, :]                       # [B, C]
    valid = col[None, :] < length[:, None]
    phys = torch.where(valid, pt[rows[:, None],
                                 torch.clamp(positions // page,
                                             max=npages - 1)], 0)
    off = torch.where(valid, positions % page, 0)
    flash = solo is not None and c % FLASH_TILE == 0 and hd <= FLASH_MAX_HD
    if not flash:
        j = torch.arange(smax, device=dev)
        ok = j[None, None, :] <= positions[:, :, None]              # [B,C,Sm]
        if window is not None:
            ok &= j[None, None, :] > positions[:, :, None] - window
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    x = tp.table_rows(params["embed"], tokens, cfg.padded_vocab).to(
        torch_dtype(cfg))                                           # [B,C,D]
    for li, bp in enumerate(params["blocks"]):
        h = apply_norm(bp["ln1"], x, eps=cfg.norm_eps, kind=cfg.norm)
        q, k, v = attn_mod.project_qkv(bp["attn"], h, cfg.num_heads, kvh, hd,
                                       cos, sin, cfg.qk_norm, cfg.norm_eps)
        pool_k[li, phys, off] = k.to(pool_k.dtype)
        pool_v[li, phys, off] = v.to(pool_v.dtype)
        if flash:
            slot, q_offset = solo
            o = torch.zeros_like(q)
            o[slot] = _flash_chunk(q[slot:slot + 1], pool_k[li], pool_v[li],
                                   pt[slot], int(q_offset), window)[0]
        else:
            o = _masked_attention(
                q, pool_k[li][pt].reshape(b, smax, kvh, hd),
                pool_v[li][pt].reshape(b, smax, kvh, hd), ok)
        x = x + attn_proj(cfg, bp["attn"], o.reshape(b, c, -1), x.dtype)
        x, _ = apply_ffn_part(cfg, bp, x)
    x = apply_norm(params["final_norm"], x, eps=cfg.norm_eps, kind=cfg.norm)
    return x, state


def reset_slot(state: dict, slot: int) -> dict:
    """Zero slot `slot`'s per-slot pieces (ssm carries, the hybrid ring,
    cross K/V; the ring's positions back to -1), and point its page table
    back at the trash page (paged) or zero its K/V rows (slot-major).
    Paged K/V pages are reclaimed by the pool allocator rather than
    zeroed: stale contents are unreachable because attention masks
    everything beyond the new request's own writes."""
    for name in SLOT_KEYS:
        if name in state:
            state[name][:, slot] = 0
    if "slot_pos" in state:
        state["slot_pos"][slot] = -1
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
    allocated in rows `slots` of the page table (`PagePool.alloc`). The
    hybrid ring takes the last min(plen, Wring) prompt positions, each at
    ring entry position % Wring."""
    for name in SLOT_KEYS:
        if name in cache and name not in ("shared_k", "shared_v"):
            state[name][:, slots] = cache[name].to(state[name].dtype)
    if "shared_k" in cache:
        wring = state["shared_k"].shape[2]
        p_range = torch.arange(plen - min(plen, wring), plen,
                               device=slots.device)
        ring = p_range % wring
        for name in ("shared_k", "shared_v"):
            state[name][:, slots[:, None], ring[None, :]] = \
                cache[name][:, :, p_range].to(state[name].dtype)
        row = torch.full((wring,), -1, dtype=torch.long, device=slots.device)
        row[ring] = p_range
        state["slot_pos"][slots] = row
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
