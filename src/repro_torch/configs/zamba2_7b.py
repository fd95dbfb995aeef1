"""zamba2-7b [arXiv:2411.15242; unverified] — Mamba2 + shared attn blocks."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    hybrid_attn_every=6,              # shared (weight-tied) attn every 6 ssm layers
    sliding_window=4096,              # used by the shared attn at long context
    tie_embeddings=True,
)
