"""Backbones: init, forward, class table and full-softmax logits.

Mirrors `src/repro/models/model.py` for every family: `init_params` (:73,
the blocks :33-143) and `forward` (:219-317) with the dense and moe
bodies (:254-260; moe's FFN through `models/moe.py`, its aux summed over
the layers and divided by `num_layers`, :317), ssm (:261-269), hybrid
(mamba2 layers with the weight-shared attention+MLP block after layer
li when li % every == every - 1, its `project_qkv` without qk-norm,
:270-289, `_shared_attn_apply` :207-216), vlm (gated cross-attention
blocks after every `cross_attn_every`-th layer over the image embeddings,
:290-308, `_apply_cross_part` :186-205) and audio (the bidirectional
encoder over the stubbed frames, `_encode` :320-333, and decoder blocks of
self-attention, cross-attention and MLP, :309-315).
Departures from the reference:
  - params are a plain dict whose `blocks` (and `cross_blocks`, and
    `encoder.blocks`) is a Python list with one dict per layer, walked by
    a Python loop, where the reference stacks leaves over layers as
    [L, ...] and scans them (`repro_torch.bridge` unstacks);
  - `init_params` draws from a `torch.Generator` on the target device and
    defaults to the card (`device=None` -> "cuda", raising without one);
  - `cast_blocks` pre-casts the block matmul weights (mamba2's conv
    weights and biases, the MoE experts) to the compute dtype once. The
    reference casts them inside every apply (`W.astype(dt)`); the cast is
    the same rounding either way, so values are unchanged, but a serving
    engine then reads bf16 weights instead of casting fp32 ones on every
    token. The MoE router and shared-expert gate and the vlm gates stay
    fp32: the reference multiplies fp32 activations by them.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_init,
                                       mlp_init, norm_init, rope_angles)


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.dtype]


def _attn(gen: torch.Generator, cfg: ModelConfig, device,
          qk_norm: bool = False) -> dict:
    return attn_mod.attn_init(gen, cfg.d_model, cfg.num_heads,
                              cfg.num_kv_heads, cfg.resolved_head_dim,
                              qk_norm, device=device)


def _attn_block_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    p = {"ln1": norm_init(cfg.d_model, cfg.norm, device=device),
         "attn": _attn(gen, cfg, device, cfg.qk_norm),
         "ln2": norm_init(cfg.d_model, cfg.norm, device=device)}
    if cfg.family == "moe":
        p["ffn"] = moe_mod.moe_init(gen, cfg.d_model, cfg.d_ff,
                                    cfg.num_experts, cfg.shared_expert_d_ff,
                                    device=device)
    else:
        p["ffn"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act,
                            device=device)
    return p


def _shared_attn_init(gen: torch.Generator, cfg: ModelConfig,
                      device) -> dict:
    """Zamba2's weight-shared attention+MLP block (no qk-norm)."""
    return {
        "ln1": norm_init(cfg.d_model, cfg.norm, device=device),
        "attn": _attn(gen, cfg, device),
        "ln2": norm_init(cfg.d_model, cfg.norm, device=device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, device=device),
    }


def _cross_block_init(gen: torch.Generator, cfg: ModelConfig,
                      device) -> dict:
    """The vlm's gated cross-attention + MLP block; both gates start at 0."""
    return {
        "ln1": norm_init(cfg.d_model, cfg.norm, device=device),
        "xattn": _attn(gen, cfg, device),
        "gate_attn": torch.zeros((), device=device),
        "ln2": norm_init(cfg.d_model, cfg.norm, device=device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, device=device),
        "gate_mlp": torch.zeros((), device=device),
    }


def _decoder_block_init(gen: torch.Generator, cfg: ModelConfig,
                        device) -> dict:
    """Whisper's decoder block: self-attention, cross-attention, MLP."""
    return {
        "ln1": norm_init(cfg.d_model, cfg.norm, device=device),
        "attn": _attn(gen, cfg, device),
        "ln_x": norm_init(cfg.d_model, cfg.norm, device=device),
        "xattn": _attn(gen, cfg, device),
        "ln2": norm_init(cfg.d_model, cfg.norm, device=device),
        "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, device=device),
    }


def num_cross_blocks(cfg: ModelConfig) -> int:
    """The vlm's cross-attention blocks (reference :110)."""
    return max(1, cfg.num_layers // cfg.cross_attn_every)


def num_shared_apps(cfg: ModelConfig) -> int:
    """The hybrid's shared-attention applications (`decode.py:89`)."""
    return max(1, cfg.num_layers // cfg.hybrid_attn_every)


def _mamba_block_init(gen: torch.Generator, cfg: ModelConfig,
                      device) -> dict:
    return {
        "ln1": norm_init(cfg.d_model, cfg.norm, device=device),
        "mamba": mamba_mod.mamba2_init(
            gen, cfg.d_model, d_state=cfg.ssm_state,
            head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand,
            conv_width=cfg.ssm_conv_width, device=device),
    }


_BLOCK_INIT = {"dense": _attn_block_init, "moe": _attn_block_init,
               "vlm": _attn_block_init, "ssm": _mamba_block_init,
               "hybrid": _mamba_block_init, "audio": _decoder_block_init}


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> dict:
    """Random fp32 params on `device` (default: the card). `generator` must
    live on that device; None seeds a fresh one with 0."""
    device = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
    vpad = cfg.padded_vocab
    params: dict[str, Any] = {
        "embed": embed_init(gen, vpad, cfg.d_model, device=device),
        "final_norm": norm_init(cfg.d_model, cfg.norm, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, vpad, cfg.d_model, device=device)
    block_init = _BLOCK_INIT[cfg.family]
    params["blocks"] = [block_init(gen, cfg, device)
                        for _ in range(cfg.num_layers)]
    if cfg.family == "audio":
        params["encoder"] = {
            "blocks": [_attn_block_init(gen, cfg, device)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": norm_init(cfg.d_model, cfg.norm, device=device)}
    if cfg.family == "hybrid":
        params["shared_attn"] = _shared_attn_init(gen, cfg, device)
    if cfg.family == "vlm":
        params["cross_blocks"] = [_cross_block_init(gen, cfg, device)
                                  for _ in range(num_cross_blocks(cfg))]
    return params


_MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "gate", "up", "down",
                   "w_gate", "w_up", "w_down",
                   "z_proj", "x_proj", "b_proj", "c_proj", "dt_proj",
                   "out_proj", "conv_x", "conv_x_b", "conv_b", "conv_b_b",
                   "conv_c", "conv_c_b")


def cast_blocks(cfg: ModelConfig, params: dict) -> dict:
    """A params dict whose block matmul weights (mamba2's conv weights and
    biases, the MoE experts) are already in the compute dtype, in
    `blocks`, `shared_attn`, `cross_blocks` and `encoder.blocks`; norm
    scales, the embedding, the head, mamba2's a_log, dt_bias, d_skip and
    norm_scale, the MoE router and shared gate and the vlm gates stay
    fp32, as the reference reads them. Shares every other tensor with
    `params`."""
    dt = torch_dtype(cfg)

    def cast(tree):
        return {k: (cast(v) if isinstance(v, dict)
                    else v.to(dt) if k in _MATMUL_WEIGHTS else v)
                for k, v in tree.items()}

    out = {**params, "blocks": [cast(bp) for bp in params["blocks"]]}
    if "shared_attn" in params:
        out["shared_attn"] = cast(params["shared_attn"])
    if "cross_blocks" in params:
        out["cross_blocks"] = [cast(cb) for cb in params["cross_blocks"]]
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {**enc, "blocks": [cast(bp) for bp in enc["blocks"]]}
    return out


def params_to(tree, device):
    """The params tree (dicts and lists of tensors) moved to `device`."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to(v, device) for v in tree]
    return tree.to(device)


def class_embeddings(cfg: ModelConfig, params: dict) -> torch.Tensor:
    """The class-embedding table the softmax head scores against. [Vpad, D]."""
    return params["embed"] if cfg.tie_embeddings else params["head"]


def apply_attn_part(cfg: ModelConfig, bp: dict, x, cos, sin, *,
                    causal: bool = True, window=None):
    """Pre-norm self-attention sublayer. Returns (x', k, v)."""
    h = apply_norm(bp["ln1"], x, eps=cfg.norm_eps, kind=cfg.norm)
    q, k, v = attn_mod.project_qkv(bp["attn"], h, cfg.num_heads,
                                   cfg.num_kv_heads, cfg.resolved_head_dim,
                                   cos, sin, cfg.qk_norm, cfg.norm_eps)
    o = attn_mod.attention(q, k, v, causal=causal, window=window)
    b, s, _, _ = o.shape
    return x + o.reshape(b, s, -1) @ bp["attn"]["wo"].to(x.dtype), k, v


def apply_ffn_part(cfg: ModelConfig, bp: dict, x):
    """Pre-norm FFN sublayer. Returns (x', aux): the moe family's row-wise
    dispatch and its aux loss (the batch mean), else the MLP and 0."""
    h = apply_norm(bp["ln2"], x, eps=cfg.norm_eps, kind=cfg.norm)
    if cfg.family == "moe":
        y, aux = moe_mod.apply_moe(bp["ffn"], h,
                                   top_k=cfg.num_experts_per_tok,
                                   capacity_factor=cfg.capacity_factor,
                                   act=cfg.act)
        return x + y, aux
    return x + apply_mlp(bp["ffn"], h, cfg.act), None


def cross_kv(cfg: ModelConfig, ap: dict, src: torch.Tensor):
    """Cross-attention keys and values of `src` [B, Ssrc, D] (no RoPE):
    k, v [B, Ssrc, KV, hd]."""
    b, sk, _ = src.shape
    shape = (b, sk, cfg.num_kv_heads, cfg.resolved_head_dim)
    return ((src @ ap["wk"].to(src.dtype)).reshape(shape),
            (src @ ap["wv"].to(src.dtype)).reshape(shape))


def cross_out(cfg: ModelConfig, bp: dict, x, o, *, gated: bool):
    """The cross sublayer after its attention output o [B, S, H·hd]: the
    output projection, then (gated, the vlm block) tanh(gate_attn) on the
    residual and the gated MLP, else the plain residual (audio)."""
    o = o @ bp["xattn"]["wo"].to(x.dtype)
    if not gated:
        return x + o
    x = x + (torch.tanh(bp["gate_attn"]) * o).to(x.dtype)
    h2 = apply_norm(bp["ln2"], x, eps=cfg.norm_eps, kind=cfg.norm)
    y = apply_mlp(bp["mlp"], h2, cfg.act)
    return x + (torch.tanh(bp["gate_mlp"]) * y).to(x.dtype)


def apply_cross_part(cfg: ModelConfig, bp: dict, x, kv_src, *,
                     gated: bool = False):
    """Cross-attention: queries from x, keys and values from kv_src
    [B, Ssrc, D] (reference `_apply_cross_part`)."""
    h = apply_norm(bp["ln1"] if gated else bp["ln_x"], x, eps=cfg.norm_eps,
                   kind=cfg.norm)
    b, s, _ = h.shape
    q = (h @ bp["xattn"]["wq"].to(h.dtype)).reshape(
        b, s, cfg.num_heads, cfg.resolved_head_dim)
    k, v = cross_kv(cfg, bp["xattn"], kv_src.to(h.dtype))
    o = attn_mod.attention(q, k, v, causal=False)
    return cross_out(cfg, bp, x, o.reshape(b, s, -1), gated=gated)


def shared_attn_mlp(cfg: ModelConfig, sp: dict, x, o):
    """The hybrid's shared block after its attention output o
    [B, S, H·hd]: the output projection and the MLP sublayer."""
    x = x + o @ sp["attn"]["wo"].to(x.dtype)
    h2 = apply_norm(sp["ln2"], x, eps=cfg.norm_eps, kind=cfg.norm)
    return x + apply_mlp(sp["mlp"], h2, cfg.act)


def apply_shared_attn(cfg: ModelConfig, sp: dict, x, cos, sin, window=None):
    """Zamba2's shared block (reference `_shared_attn_apply`). Returns
    (x', k, v)."""
    h = apply_norm(sp["ln1"], x, eps=cfg.norm_eps, kind=cfg.norm)
    q, k, v = attn_mod.project_qkv(sp["attn"], h, cfg.num_heads,
                                   cfg.num_kv_heads, cfg.resolved_head_dim,
                                   cos, sin)
    o = attn_mod.attention(q, k, v, causal=True, window=window)
    b, s, _, _ = o.shape
    return shared_attn_mlp(cfg, sp, x, o.reshape(b, s, -1)), k, v


def encode(cfg: ModelConfig, enc: dict, frames: torch.Tensor) -> torch.Tensor:
    """Whisper-style bidirectional encoder over the stubbed frame
    embeddings [B, Senc, D] (reference `_encode`)."""
    x = frames.to(torch_dtype(cfg))
    cos, sin = rope_angles(torch.arange(x.shape[1], device=x.device),
                           cfg.resolved_head_dim, cfg.rope_theta)
    for bp in enc["blocks"]:
        x, _, _ = apply_attn_part(cfg, bp, x, cos, sin, causal=False)
        x, _ = apply_ffn_part(cfg, bp, x)
    return apply_norm(enc["final_norm"], x, eps=cfg.norm_eps, kind=cfg.norm)


def apply_mamba_part(cfg: ModelConfig, bp: dict, x, *,
                     chunk: Optional[int] = None, return_state: bool = False):
    """Pre-norm mamba2 sublayer: x + mamba2(norm(x)), and with
    return_state its decode carry."""
    h = apply_norm(bp["ln1"], x, eps=cfg.norm_eps, kind=cfg.norm)
    out = mamba_mod.apply_mamba2(
        bp["mamba"], h, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
        expand=cfg.ssm_expand, chunk=chunk or cfg.ssm_chunk,
        return_state=return_state)
    if return_state:
        return x + out[0], out[1]
    return x + out


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            image_emb: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            window: Optional[int] = None,
            inputs_embeds: Optional[torch.Tensor] = None) -> dict:
    """tokens [B,S] int -> {"hidden": [B,S,D], "aux_loss": scalar}.
    image_emb [B, Ni, D] (vlm) and frames [B, Senc, D] (audio) are the
    stubbed media embeddings. window: the sliding window of the dense /
    moe self-attention and the hybrid's shared block. inputs_embeds
    [B,S,D]: the token embeddings, computed by the caller (the
    vocab-parallel lookup, `dist.vocab_parallel.embed_lookup`), in place
    of the lookup in `params["embed"]` (reference :223-236)."""
    s = tokens.shape[1]
    # F.embedding, not params["embed"][tokens]: the same rows, and on the
    # CPU a backward that sums repeated tokens in a fixed order.
    x = (inputs_embeds if inputs_embeds is not None
         else F.embedding(tokens, params["embed"])).to(torch_dtype(cfg))
    aux = torch.zeros((), device=x.device)
    fam = cfg.family
    if fam != "ssm":
        cos, sin = rope_angles(torch.arange(s, device=tokens.device),
                               cfg.resolved_head_dim, cfg.rope_theta)
    enc_out = encode(cfg, params["encoder"], frames) if fam == "audio" \
        else None
    for li, bp in enumerate(params["blocks"]):
        if fam in ("ssm", "hybrid"):
            x = apply_mamba_part(cfg, bp, x)
            every = cfg.hybrid_attn_every
            if fam == "hybrid" and li % every == every - 1:
                x, _, _ = apply_shared_attn(cfg, params["shared_attn"], x,
                                            cos, sin, window)
            continue
        x, _, _ = apply_attn_part(cfg, bp, x, cos, sin,
                                  window=window if fam in ("dense", "moe")
                                  else None)
        if fam == "audio":
            x = apply_cross_part(cfg, bp, x, enc_out)
        x, a = apply_ffn_part(cfg, bp, x)
        if a is not None:
            aux = aux + a
        every = cfg.cross_attn_every
        if fam == "vlm" and li % every == every - 1:
            x = apply_cross_part(cfg, params["cross_blocks"][li // every], x,
                                 image_emb, gated=True)
    x = apply_norm(params["final_norm"], x, eps=cfg.norm_eps, kind=cfg.norm)
    return {"hidden": x, "aux_loss": aux / cfg.num_layers}


def logits_full(cfg: ModelConfig, params: dict,
                hidden: torch.Tensor) -> torch.Tensor:
    """Full softmax head: [.., D] -> [.., Vpad] (fp32)."""
    table = class_embeddings(cfg, params)
    return hidden.float() @ table.float().T
