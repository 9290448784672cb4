"""Qwen3-8B [hf:Qwen/Qwen3-8B]: 36L d=4096 32H GQA(kv=8) ff=12288
vocab=151936 — qk_norm, GQA, head_dim 128."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12288, vocab=151936, qk_norm=True, rope_theta=1e6,
)
