"""Gemma-2B [arXiv:2403.08295]: 18L d=2048 8H MQA(kv=1) ff=16384
vocab=256000 — GeGLU activation, head_dim=256."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000, act="gelu", rope_theta=1e4,
    tie_embeddings=True,
)
