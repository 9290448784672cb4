"""ModelConfig — one dataclass describing every assigned architecture.

Heterogeneous stacks (Jamba) are expressed as a repeating *period* of
sublayers: `attn_every=8` means each period has 1 attention + 7 Mamba
mixers; `moe_every=2` alternates dense/MoE MLPs inside the period.  The
stack loops over `n_layers / period` identical periods, so per-kind
parameters stack along a leading period axis, as the reference's
parameter tree does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|vlm|audio|hybrid|ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    act: str = "silu"              # silu | gelu (GeGLU)
    qk_norm: bool = False
    rope_theta: float = 1e6
    m_rope: bool = False
    m_rope_sections: Tuple[int, int, int] = (16, 24, 24)
    causal: bool = True            # False => bidirectional encoder
    has_decode: bool = True        # False => encoder-only (no KV cache)
    tie_embeddings: bool = False
    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1             # MoE MLP on every k-th layer of a period
    moe_dense_residual: bool = False  # Arctic: dense MLP in parallel w/ MoE
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    attn_every: int = 0            # 0: all-attn; k>1: 1 attn per k layers;
    #                                -1: attention-free (pure SSM)
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_state: int = 128
    ssm_chunk: int = 128
    # --- modality frontend stubs ---
    frontend: str = "none"         # none | patch (VLM) | frame (audio)
    patch_dim: int = 1176          # raw patch embedding dim (Qwen2-VL)
    # --- execution knobs ---
    flash_chunk: int = 1024
    ce_chunk: int = 512            # sequence chunking for the CE loss

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def period(self) -> int:
        if self.attn_every > 1:
            return self.attn_every if self.moe_every <= 1 else \
                _lcm(self.attn_every, self.moe_every)
        return max(self.moe_every, 1)

    @property
    def n_periods(self) -> int:
        assert self.n_layers % self.period == 0, (self.n_layers, self.period)
        return self.n_layers // self.period

    def slot_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """Per sublayer slot within a period: (mixer, mlp) kinds."""
        out = []
        for j in range(self.period):
            if self.attn_every == -1:
                mixer = "ssm"
            elif self.attn_every > 1:
                # Jamba: attention in the middle of the period (1:7 ratio)
                mixer = "attn" if j == self.attn_every // 2 else "ssm"
            else:
                mixer = "attn"
            if mixer == "ssm":
                mlp = "none" if self.family == "ssm" else \
                    ("moe" if (self.moe_experts and j % self.moe_every == 1)
                     else "dense")
            elif self.moe_experts and (self.moe_every <= 1
                                       or j % self.moe_every == 1):
                mlp = "moe"
            else:
                mlp = "dense"
            out.append((mixer, mlp))
        return tuple(out)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        period = self.period
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=max(period, 2 if period == 1 else period),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads
            else 2,
            head_dim=16,
            d_ff=128,
            vocab=512,
            moe_experts=min(self.moe_experts, 4) if self.moe_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            moe_d_ff=64 if self.moe_experts else 0,
            ssm_heads=4 if self.ssm_heads else 0,
            ssm_head_dim=8 if self.ssm_heads else 64,
            ssm_state=16 if self.ssm_heads else 128,
            ssm_chunk=8,
            m_rope_sections=(2, 3, 3),
            patch_dim=32,
            flash_chunk=64,
            ce_chunk=32,
        )


def _lcm(a, b):
    import math
    return a * b // math.gcd(a, b)


# ----------------------------------------------------------------------------
# Input shapes (the assigned shape set; see launch/shapes.py for specs)
# ----------------------------------------------------------------------------
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="long_decode", seq_len=524288, global_batch=1),
}
