"""Transformer building blocks: RMSNorm, RoPE / M-RoPE, GQA attention
(chunked-flash for train/prefill, single-token for decode), gated MLPs.

Params are a plain nested dict of tensors (no ``nn.Module`` inside).
Every matmul multiplies bf16 operands into an f32 result, as the
reference's ``preferred_element_type=float32`` products do:

* on the card, ``torch.mm`` / ``torch.bmm`` with ``out_dtype=float32``
  (cuBLAS bf16 GEMMs that keep the f32 accumulator; the package turns
  reduced-precision bf16 reductions off);
* on the CPU, the f32 product of the bf16-rounded operands, which is
  what XLA's CPU backend computes.

Products of three operands (the SSD einsums) are taken in f32 from the
bf16-rounded operands on every device: a product of three bf16 values
is exact in f32, as in the reference's pairwise contraction.

Gradients.  JAX transposes a product of bf16 operands into f32 products
of the f32 cotangent with the other bf16 operand, each rounded to bf16
(the operand's dtype).  The CPU branch gets exactly that from autograd.
``torch.mm`` / ``torch.bmm`` with ``out_dtype`` register no derivative,
so on the card (and on meta tensors, which stand in for it when the
launch tooling traces a step) `_dot` / `_bmm` go through `_MmF32` /
`_BmmF32` when a gradient is needed: the forward is the same call, and
the backward rounds the cotangent to bf16 before its two bf16 GEMMs
(f32 results, then rounded to bf16), as a TPU does at default
precision.  Rounding the cotangent is the one difference from the CPU:
each gradient moves by at most ~2^-9 of the cotangent's scale before its
own bf16 rounding.

`flash_attention` updates its score tensor in place only when no
gradient is taken (serving); under a gradient it uses the out-of-place
forms of the same ops, which give the same values bit for bit.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

COMPUTE_DTYPE = torch.bfloat16


def _bf(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and held in f32 (the CPU's operand)."""
    return x.to(COMPUTE_DTYPE).to(torch.float32)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 a (M, K) @ bf16 b (K, N) -> f32 (M, N), f32 accumulation
    (on the CPU the f32 product of the bf16 values)."""
    if a.device.type == "cpu":
        return a.to(torch.float32) @ b.to(torch.float32)
    return torch.mm(a, b, out_dtype=torch.float32)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched bf16 a (L, M, K) @ bf16 b (L, K, N) -> f32 (L, M, N)."""
    if a.device.type == "cpu":
        return a.to(torch.float32) @ b.to(torch.float32)
    return torch.bmm(a, b, out_dtype=torch.float32)


class _MmF32(torch.autograd.Function):
    """`_mm_f32` with the card's backward: the cotangent rounded to bf16,
    each operand's gradient a bf16 GEMM into f32 rounded to bf16.  It
    saves the bf16 operands it was given."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(COMPUTE_DTYPE)
        ga = _mm_f32(g, b.t()).to(a.dtype) if ctx.needs_input_grad[0] \
            else None
        gb = _mm_f32(a.t(), g).to(b.dtype) if ctx.needs_input_grad[1] \
            else None
        return ga, gb


class _BmmF32(torch.autograd.Function):
    """`_bmm_f32` with the card's backward (as `_MmF32`)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bmm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(COMPUTE_DTYPE)
        ga = _bmm_f32(g, b.transpose(1, 2)).to(a.dtype) \
            if ctx.needs_input_grad[0] else None
        gb = _bmm_f32(a.transpose(1, 2), g).to(b.dtype) \
            if ctx.needs_input_grad[1] else None
        return ga, gb


def _card_grad(a: torch.Tensor, b: torch.Tensor) -> bool:
    """A gradient through a product on the card, where only the autograd
    Functions give one (the CPU's autograd takes the product itself).
    Meta tensors stand in for the card (the launch tooling traces the
    steps on them), so they take the same Functions."""
    return a.device.type in ("cuda", "meta") and torch.is_grad_enabled() \
        and (a.requires_grad or b.requires_grad)


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) with bf16 operands -> f32 (..., N)."""
    a = x.reshape(-1, x.shape[-1]).to(COMPUTE_DTYPE)
    b = w.to(COMPUTE_DTYPE)
    y = _MmF32.apply(a, b) if _card_grad(a, b) else _mm_f32(a, b)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a (..., M, K) @ b (..., K, N), same leading dims, bf16
    operands -> f32 (..., M, N)."""
    a3 = a.to(COMPUTE_DTYPE).reshape(-1, *a.shape[-2:])
    b3 = b.to(COMPUTE_DTYPE).reshape(-1, *b.shape[-2:])
    y = _BmmF32.apply(a3, b3) if _card_grad(a3, b3) else _bmm_f32(a3, b3)
    return y.reshape(*a.shape[:-2], a.shape[-2], b.shape[-1])


def _dot_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (T, K) @ w (K, N) in bf16 with a bf16 result: the reference's
    plain ``@`` of two bf16 arrays (f32 accumulation, one rounding)."""
    if x.device.type != "cpu":
        return torch.mm(x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE))
    return (_bf(x) @ _bf(w)).to(COMPUTE_DTYPE)


def rms_norm(x, scale, eps=1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
            ).to(x.dtype)


# ----------------------------------------------------------------------------
# RoPE / M-RoPE
# ----------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float = 1e4, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x, ang):
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x, positions, theta: float = 1e4):
    """x: (B, S, H, hd); positions: (B, S) int32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (hd/2,)
    ang = positions[:, :, None].to(torch.float32) * freqs   # (B, S, hd/2)
    return _rotate(x, ang)


def apply_m_rope(x, positions3, sections, theta: float = 1e4):
    """Qwen2-VL multimodal RoPE.  positions3: (3, B, S) for (t, h, w);
    `sections` partitions hd/2 frequencies across the three axes."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (hd/2,)
    sec = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])
    pos = positions3[sec]                                   # (hd/2, B, S)
    ang = torch.movedim(pos, 0, -1).to(torch.float32) * freqs
    return _rotate(x, ang)


# ----------------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------------
def _repeat_kv(k, n_rep):
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _attn_scale(hd: int) -> float:
    """1/sqrt(hd) as the reference's f32 scalar, held in a Python float."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def flash_attention(q, k, v, *, causal: bool, chunk: int = 1024,
                    window: Optional[int] = None):
    """Online-softmax attention over KV chunks (O(S) memory per chunk).
    q: (B, Sq, H, hd); k, v: (B, Sk, KvH, hd) — KvH repeated to H here.
    Every chunk is computed, the causally masked ones included.  The
    score tensor is updated in place unless a gradient is taken."""
    b, sq, h, hd = q.shape
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    qf = (q.to(torch.float32) * _attn_scale(hd)).to(COMPUTE_DTYPE)
    qf = qf.permute(0, 2, 1, 3)                             # (b, h, q, d)
    nchunks = max(sk // chunk, 1)
    csize = sk // nchunks
    kc = k.reshape(b, nchunks, csize, h, hd)
    vc = v.reshape(b, nchunks, csize, h, hd)
    q_pos = torch.arange(sq, device=q.device)

    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    for j in range(nchunks):
        kj = kc[:, j].permute(0, 2, 3, 1)                   # (b, h, d, k)
        vj = vc[:, j].permute(0, 2, 1, 3)                   # (b, h, k, d)
        s = _bmm(qf, kj)                                    # (b, h, q, k)
        kv_pos = j * csize + torch.arange(csize, device=q.device)
        mask = torch.ones((sq, csize), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= kv_pos[None, :]
        if window is not None:
            mask &= q_pos[:, None] - kv_pos[None, :] < window
        if grad:
            s = s.masked_fill(~mask, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            p = (s - m_new[..., None]).exp()
        else:
            s.masked_fill_(~mask, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            p = s.sub_(m_new[..., None]).exp_()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _bmm(p.to(COMPUTE_DTYPE), vj)
        m = m_new
        del s, p
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)              # (B, Sq, H, hd)


def decode_attention(q, k_cache, v_cache, kv_len):
    """Single-token attention against a (B, Smax, KvH, hd) cache.
    kv_len: (B,) current lengths (positions >= kv_len masked)."""
    b, smax, kvh, hd = k_cache.shape
    h = q.shape[2]
    n_rep = h // kvh
    qh = (q[:, 0].to(torch.float32) * _attn_scale(hd)).to(COMPUTE_DTYPE)
    qg = qh.reshape(b, kvh, n_rep, hd)
    s = _bmm(qg, k_cache.to(COMPUTE_DTYPE).permute(0, 2, 3, 1))
    mask = torch.arange(smax, device=q.device)[None] < kv_len[:, None]
    s = s.masked_fill(~mask[:, None, None], -math.inf)      # (B,KvH,rep,S)
    p = torch.softmax(s, dim=-1)
    out = _bmm(p.to(COMPUTE_DTYPE),
               v_cache.to(COMPUTE_DTYPE).permute(0, 2, 1, 3))
    return out.reshape(b, 1, h, hd).to(q.dtype)


# ----------------------------------------------------------------------------
# Projections / MLP
# ----------------------------------------------------------------------------
def attention_proj(x, wq, wk, wv, n_heads, n_kv_heads, head_dim,
                   q_norm=None, k_norm=None):
    b, s, _ = x.shape
    q = _dot(x, wq).reshape(b, s, n_heads, head_dim)
    k = _dot(x, wk).reshape(b, s, n_kv_heads, head_dim)
    v = _dot(x, wv).reshape(b, s, n_kv_heads, head_dim)
    if q_norm is not None:                      # Qwen3 qk_norm (per head_dim)
        q = rms_norm(q, q_norm)
        k = rms_norm(k, k_norm)
    return q, k, v


def activation(g, act: str):
    return F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")


def gated_mlp(x, w_gate, w_up, w_down, act: str = "silu"):
    g = _dot(x, w_gate)
    u = _dot(x, w_up)
    return _dot((activation(g, act) * u).to(x.dtype), w_down)


# ----------------------------------------------------------------------------
# Init helpers
# ----------------------------------------------------------------------------
def dense_init(generator: torch.Generator, shape, scale=None, device=None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device) * s
