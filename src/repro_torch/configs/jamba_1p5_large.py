"""Jamba-1.5-Large (398B) [arXiv:2403.19887]: 72L d=8192 64H GQA(kv=8)
ff=24576 vocab=65536 — Mamba:attention 7:1 interleave (period 8, attn at
slot 4), MoE 16 experts top-2 on alternating layers.  The Mamba mixer is
implemented as Mamba-2/SSD (state-space duality) — see DESIGN.md
§Arch-applicability for the adaptation note."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536, rope_theta=1e4,
    attn_every=8, moe_experts=16, moe_top_k=2, moe_d_ff=24576, moe_every=2,
    ssm_heads=256, ssm_head_dim=64, ssm_state=128,
)
