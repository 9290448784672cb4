"""Mamba2-2.7B [arXiv:2405.21060]: 64L d=2560 attention-free, SSD
(state-space duality), d_inner=2*2560 -> 80 heads of 64, ssm_state=128,
vocab=50280."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab=50280, attn_every=-1,
    ssm_heads=80, ssm_head_dim=64, ssm_state=128,
    tie_embeddings=True,
)
