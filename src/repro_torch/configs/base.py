"""Config system: model architecture + input shapes + head (sampler) config.

Mirrors `src/repro/configs/base.py` field for field (a copy, not an import:
`repro/__init__.py` imports jax). One `ModelConfig` describes any of the 10
assigned architectures plus the paper's own small LM. `reduced()` derives
the CPU smoke-test variant. The port runs the `dense` and `ssm` families
so far; the other families' configs are carried as data.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    """The paper's technique — sampled softmax head configuration."""
    # Head mode — any repro.proposals contender ('midx' and 'full' keep the
    # dedicated fast lanes in models/heads.py; the rest route through
    # heads.loss_sampled): 'midx' | 'full' | 'uniform' | 'unigram' |
    # 'sphere' | 'rff' | 'rff-fused' | 'lsh' | 'tapas' | 'midx-learnable'.
    mode: str = "midx"
    quantizer: str = "rq"         # 'pq' | 'rq'
    midx_k: int = 64              # codewords per codebook
    num_negatives: int = 1024     # M
    proposal: str = "pooled"      # 'per_token' | 'pooled' | 'mixture'
    refresh_every: int = 100      # steps between index refresh events
    kmeans_iters: int = 8
    # Non-MIDX proposal knobs (repro.proposals.registry.from_config):
    sphere_alpha: float = 100.0   # quadratic-kernel weight (Blanc & Rendle)
    rff_dim: int = 32             # random Fourier features R
    rff_tau: float = 4.0          # softmax-kernel temperature
    tapas_pool: int = 256         # TAPAS pass-1 candidate pool size P
    tapas_eps: float = 0.05       # TAPAS uniform-mixture floor
    # midx-learnable: SGD rate for the codebook leaves + aux-loss weights
    # (L_recon / L_KL, paper §6.2.3)
    learnable_lr: float = 1e-2
    aux_recon_weight: float = 1.0
    aux_kl_weight: float = 1.0
    # Index lifecycle (repro.index, DESIGN §8):
    #   refresh_policy 'fixed'  — every event is a full (warm-started) refit;
    #                  'drift'  — reassign-only rebuild, escalating to the
    #                             full refit when the drift metric (fraction
    #                             of reassigned classes OR relative codeword
    #                             movement) exceeds refresh_drift_threshold.
    #   refresh_lag    staleness window: the rebuild dispatched at step s is
    #                  swapped in at step s+lag, overlapping with training
    #                  (0 = synchronous swap at dispatch).
    refresh_policy: str = "fixed"
    refresh_drift_threshold: float = 0.1
    refresh_lag: int = 0
    learnable_codebooks: bool = False
    mask_collisions: bool = True
    # MIDX decode head (serving): candidates drawn per step and the sampling
    # temperature — `heads.midx_decode_head` reads these when its arguments
    # are left as None (DESIGN §5).
    decode_candidates: int = 64
    decode_temperature: float = 1.0
    # Route loss_midx through the fused Pallas head (kernel proposal tables
    # + flash-CE; DESIGN §3). Takes effect on backends that can run the
    # kernels (TPU, or interpret mode) — elsewhere kernels.dispatch falls
    # back to the jnp path, so this default is safe for the CPU suite.
    use_fused_head: bool = True
    # Quantized hot path (DESIGN §12): storage dtype of the class table on
    # the head's hot path — 'bf16' keeps the native-precision table; 'int8'
    # / 'fp8' (e4m3) add a per-row-scaled low-bit copy that the CE kernels,
    # proposal pass and decode head read, with the master-precision table
    # retained for the optimizer update (straight-through estimator).
    # Unknown values raise at step-build time (steps.resolve_table_dtype).
    table_dtype: str = "bf16"
    # Re-quantize the low-bit copy (and refit the residual codes) at every
    # index refresh event, riding the IndexLifecycle double buffer; False
    # freezes the low-bit copy at its init-time values.
    quantize_on_refresh: bool = True


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-engine shape knobs (repro.serve, DESIGN §5).

    `max_slots` bounds the slot-packed decode batch; each slot owns
    `pages_per_slot = ceil(max_seq / page_size)` page-table entries into a
    shared pool of `num_pages` physical KV pages (0 → full residency:
    every slot can hold max_seq tokens simultaneously, plus the reserved
    trash page).

    DESIGN §13 knobs: `spec_decode` turns on MIDX-draft speculative decoding
    (k draft tokens per slot per wave, one batched full-head verify pass;
    0 = off), `prefill_chunk` bounds prefill work per engine wave (prompts
    prefill in page-aligned chunks of at most this many tokens, interleaved
    with decode waves; 0 = whole-prompt batched prefill), and `prefix_cache`
    enables the refcounted prompt-prefix page cache (requires a chunked
    prefill budget so a cache-hit prompt can resume mid-prompt).
    """
    max_slots: int = 8
    page_size: int = 16
    max_seq: int = 256            # logical per-slot capacity (prompt + gen)
    num_pages: int = 0            # 0 -> max_slots * pages_per_slot + 1
    max_queue: int = 0            # bounded intake queue; 0 -> unbounded
    spec_decode: int = 0          # draft tokens per wave; 0 -> non-speculative
    prefill_chunk: int = 0        # prefill-token budget per wave; 0 -> batched
    prefix_cache: bool = False    # share prompt-prefix pages across requests

    @property
    def pages_per_slot(self) -> int:
        return -(-self.max_seq // self.page_size)

    @property
    def resolved_num_pages(self) -> int:
        # +1 for the reserved trash page (physical page 0) inactive slots
        # write into; it is never allocated to a request.
        return self.num_pages or self.max_slots * self.pages_per_slot + 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    # attention options
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # used at long context (hybrid)
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    # hybrid (zamba2): shared attention block every k ssm layers
    hybrid_attn_every: int = 0
    # vlm: cross-attention block every k self-attn layers
    cross_attn_every: int = 0
    num_image_tokens: int = 0
    # audio / enc-dec (whisper): frame-embedding stub feeds the encoder
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0
    # misc
    norm_eps: float = 1e-5
    norm: str = "rmsnorm"         # 'rmsnorm' | 'layernorm'
    tie_embeddings: bool = True
    act: str = "silu"             # 'silu' (SwiGLU) | 'gelu'
    dtype: str = "bfloat16"
    remat: bool = True
    vocab_pad_multiple: int = 128
    head: HeadConfig = dataclasses.field(default_factory=HeadConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, self.vocab_pad_multiple)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def with_head(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, head=dataclasses.replace(self.head, **kw))

    def with_serve(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, serve=dataclasses.replace(self.serve, **kw))

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            num_layers=2,
            d_model=64,
            num_heads=max(2, min(self.num_heads, 4)),
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            vocab_pad_multiple=16,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2) if self.num_experts else 0,
            shared_expert_d_ff=64 if self.shared_expert_d_ff else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            num_image_tokens=8 if self.num_image_tokens else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=16 if self.encoder_seq else 0,
            head=dataclasses.replace(self.head, midx_k=8, num_negatives=16,
                                     kmeans_iters=3),
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                     # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                     # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


LM_SHAPES = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
