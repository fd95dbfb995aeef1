"""The paper's own LM setup (§6.2): 2-layer transformer, d=200, 4 heads,
d_ff=1024, PTB-scale vocab — used for the faithful-reproduction benchmarks."""
from repro_torch.configs.base import ModelConfig, HeadConfig

CONFIG = ModelConfig(
    name="paper-lm", family="dense",
    num_layers=2, d_model=200, num_heads=4, num_kv_heads=4,
    d_ff=1024, vocab_size=10000, head_dim=50,
    tie_embeddings=True, vocab_pad_multiple=16,
    head=HeadConfig(mode="midx", quantizer="rq", midx_k=32, num_negatives=20,
                    proposal="per_token", refresh_every=50),
)
