"""HuBERT-XLarge [arXiv:2106.07447]: 48L d=1280 16H ff=5120 vocab=504 —
encoder-only (bidirectional, no decode shapes), conv feature extractor
is a STUB per spec (input_specs supplies frame embeddings)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=504, rope_theta=1e4,
    causal=False, has_decode=False, frontend="frame",
)
