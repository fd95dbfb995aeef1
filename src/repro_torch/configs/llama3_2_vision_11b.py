"""llama-3.2-vision-11b [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

Transformer BACKBONE only: 40 self-attn layers with a cross-attention block
every 5 layers attending to stubbed image patch embeddings (input_specs()
provides precomputed [B, num_image_tokens, d_model] embeddings).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    cross_attn_every=5, num_image_tokens=1600,
    rope_theta=500_000.0, tie_embeddings=False,
)
