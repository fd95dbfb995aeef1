"""whisper-tiny [arXiv:2212.04356; unverified] — enc-dec backbone.

Conv frontend is a STUB: input_specs() provides precomputed frame embeddings
[B, encoder_seq, d_model]. The 32k shapes apply to the decoder side.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    is_encoder_decoder=True, encoder_layers=4, encoder_seq=1500,
    act="gelu", norm="layernorm", tie_embeddings=True,
)
