"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf] — 32e top-8."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155,
    num_experts=32, num_experts_per_tok=8,
    rope_theta=10000.0, tie_embeddings=True,
)
