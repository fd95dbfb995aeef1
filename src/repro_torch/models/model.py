"""Backbones: init, forward, class table and full-softmax logits.

Mirrors `src/repro/models/model.py` for the `dense` and `ssm` (mamba2)
families: `init_params` (:73; the ssm blocks `{ln1, mamba}` :54-60,
:94-96) and `forward` (:215; the ssm body, pre-norm mamba2 and no RoPE,
:238-240, :257-265). The MoE, hybrid, VLM and audio branches are later
slices and raise here.
Departures from the reference:
  - params are a plain dict whose `blocks` is a Python list with one dict
    per layer, walked by a Python loop, where the reference stacks leaves
    over layers as [L, ...] and scans them (`repro_torch.bridge` unstacks);
  - `init_params` draws from a `torch.Generator` on the target device and
    defaults to the card (`device=None` -> "cuda", raising without one);
  - `cast_blocks` pre-casts the block matmul weights (and mamba2's conv
    weights and biases) to the compute dtype once. The reference casts
    them inside every apply (`W.astype(dt)`); the cast is the same
    rounding either way, so values are unchanged, but a serving engine
    then reads bf16 weights instead of casting fp32 ones on every token.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_init,
                                       mlp_init, norm_init, rope_angles)


PORTED_FAMILIES = ("dense", "ssm")


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the torch port runs the {' and '.join(PORTED_FAMILIES)} "
            f"families; {cfg.name} is {cfg.family!r} (see ROADMAP.md Queue 1 "
            "item 12b)")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.dtype]


def _attn_block_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    return {
        "ln1": norm_init(cfg.d_model, cfg.norm, device=device),
        "attn": attn_mod.attn_init(gen, cfg.d_model, cfg.num_heads,
                                   cfg.num_kv_heads, cfg.resolved_head_dim,
                                   cfg.qk_norm, device=device),
        "ln2": norm_init(cfg.d_model, cfg.norm, device=device),
        "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, device=device),
    }


def _mamba_block_init(gen: torch.Generator, cfg: ModelConfig,
                      device) -> dict:
    return {
        "ln1": norm_init(cfg.d_model, cfg.norm, device=device),
        "mamba": mamba_mod.mamba2_init(
            gen, cfg.d_model, d_state=cfg.ssm_state,
            head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand,
            conv_width=cfg.ssm_conv_width, device=device),
    }


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> dict:
    """Random fp32 params on `device` (default: the card). `generator` must
    live on that device; None seeds a fresh one with 0."""
    require_ported(cfg)
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
    block_init = (_mamba_block_init if cfg.family == "ssm"
                  else _attn_block_init)
    params["blocks"] = [block_init(gen, cfg, device)
                        for _ in range(cfg.num_layers)]
    return params


_MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "gate", "up", "down",
                   "z_proj", "x_proj", "b_proj", "c_proj", "dt_proj",
                   "out_proj", "conv_x", "conv_x_b", "conv_b", "conv_b_b",
                   "conv_c", "conv_c_b")


def cast_blocks(cfg: ModelConfig, params: dict) -> dict:
    """A params dict whose block matmul weights (and mamba2's conv weights
    and biases) are already in the compute dtype; norm scales, the
    embedding, the head and mamba2's a_log, dt_bias, d_skip and norm_scale
    stay fp32, as the reference reads them. Shares every other tensor with
    `params`."""
    dt = torch_dtype(cfg)

    def cast(tree):
        return {k: (cast(v) if isinstance(v, dict)
                    else v.to(dt) if k in _MATMUL_WEIGHTS else v)
                for k, v in tree.items()}

    return {**params, "blocks": [cast(bp) for bp in params["blocks"]]}


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
    h = apply_norm(bp["ln2"], x, eps=cfg.norm_eps, kind=cfg.norm)
    return x + apply_mlp(bp["ffn"], h, cfg.act)


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
            window: Optional[int] = None,
            inputs_embeds: Optional[torch.Tensor] = None) -> dict:
    """tokens [B,S] int -> {"hidden": [B,S,D], "aux_loss": scalar}.
    inputs_embeds [B,S,D]: the token embeddings, computed by the caller
    (the vocab-parallel lookup, `dist.vocab_parallel.embed_lookup`), in
    place of the lookup in `params["embed"]` (reference :223-236)."""
    require_ported(cfg)
    s = tokens.shape[1]
    # F.embedding, not params["embed"][tokens]: the same rows, and on the
    # CPU a backward that sums repeated tokens in a fixed order.
    x = (inputs_embeds if inputs_embeds is not None
         else F.embedding(tokens, params["embed"])).to(torch_dtype(cfg))
    if cfg.family == "ssm":
        for bp in params["blocks"]:
            x = apply_mamba_part(cfg, bp, x)
    else:
        cos, sin = rope_angles(torch.arange(s, device=tokens.device),
                               cfg.resolved_head_dim, cfg.rope_theta)
        for bp in params["blocks"]:
            x, _, _ = apply_attn_part(cfg, bp, x, cos, sin, window=window)
            x = apply_ffn_part(cfg, bp, x)
    x = apply_norm(params["final_norm"], x, eps=cfg.norm_eps, kind=cfg.norm)
    return {"hidden": x, "aux_loss": torch.zeros((), device=x.device)}


def logits_full(cfg: ModelConfig, params: dict,
                hidden: torch.Tensor) -> torch.Tensor:
    """Full softmax head: [.., D] -> [.., Vpad] (fp32)."""
    table = class_embeddings(cfg, params)
    return hidden.float() @ table.float().T
