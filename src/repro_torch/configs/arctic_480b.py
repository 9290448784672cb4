"""Snowflake Arctic (480B) [hf:Snowflake/snowflake-arctic-base]: 35L
d=7168 56H GQA(kv=8) ff=4864 vocab=32000, MoE 128 experts top-2 with a
dense residual MLP in parallel (Arctic's dense-MoE hybrid)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab=32000, rope_theta=1e4,
    moe_experts=128, moe_top_k=2, moe_d_ff=4864, moe_every=1,
    moe_dense_residual=True,
)
