"""Qwen2-VL-7B [arXiv:2409.12191]: 28L d=3584 28H GQA(kv=4) ff=18944
vocab=152064 — M-RoPE (t/h/w sections), dynamic-resolution vision
frontend is a STUB per spec (input_specs supplies patch embeddings)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab=152064, rope_theta=1e6,
    m_rope=True, m_rope_sections=(16, 24, 24),
    frontend="patch", patch_dim=1176,
)
