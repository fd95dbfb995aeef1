"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B; hf] — 4 shared + 60 routed top-4."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=151936,
    num_experts=60, num_experts_per_tok=4,
    shared_expert_d_ff=4 * 1408,       # 4 shared experts fused into one FFN
    rope_theta=1_000_000.0, tie_embeddings=False,
)
