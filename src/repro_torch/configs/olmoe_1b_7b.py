"""OLMoE-1B-7B [arXiv:2409.02060]: 16L d=2048 16H ff(expert)=1024
vocab=50304, MoE 64 experts top-8 (every layer)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab=50304, rope_theta=1e4,
    moe_experts=64, moe_top_k=8, moe_d_ff=1024, moe_every=1,
)
