"""Mamba-2 (SSD — state-space duality) block, chunked-scan formulation.

Implements the minimal SSD recurrence of arXiv:2405.21060:
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t xᵀ_t        (per head)
    y_t = C_tᵀ h_t + D x_t
computed chunk-parallel: quadratic attention-like form within chunks,
state passing across chunks (a loop over chunk boundaries) — O(S·P·N)
work, O(S) memory.  The single-token recurrence (`mamba2_step`) carries
(h, conv window).

Shapes: d_inner = expand·d_model split into H heads of P=head_dim;
B/C shared across heads (ngroups=1), state size N = ssm_state.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import _bf, _dot, rms_norm


class MambaState(NamedTuple):
    h: torch.Tensor       # (B, H, P, N) SSM state
    conv: torch.Tensor    # (B, W-1, conv_channels) depthwise-conv tail


def _softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (no threshold)."""
    return torch.log1p(torch.exp(-x.abs())) + torch.clamp_min(x, 0)


def _segsum(dtA):  # (..., T) -> (..., T, T) lower-tri cumulative sums
    t = dtA.shape[-1]
    x = torch.cumsum(dtA, dim=-1)
    diff = x[..., :, None] - x[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                 device=dtA.device))
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(x, dt, A_log, B, C, D, chunk: int = 128):
    """x: (b, s, h, p); dt: (b, s, h); A_log: (h,); B, C: (b, s, n).
    Returns y: (b, s, h, p) and final state (b, h, p, n)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    s0 = s
    pad = (-s) % chunk if s > chunk else 0
    if s < chunk:
        chunk = s
    if pad:
        # dt -> -1e9 so softplus(dt)=0: pad steps leave state untouched
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad), value=-1e9)
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    cs = chunk
    A = -torch.exp(A_log.to(torch.float32))                  # (h,) negative
    dt = _softplus(dt.to(torch.float32))                     # (b, s, h)
    xr = x.reshape(b, nc, cs, h, p)
    dtr = dt.reshape(b, nc, cs, h)
    Br = B.reshape(b, nc, cs, n)
    Cr = C.reshape(b, nc, cs, n)
    dtA = dtr * A[None, None, None, :]                       # (b, nc, cs, h)

    # --- intra-chunk (quadratic within the chunk, SSD "attention" form)
    L = torch.exp(_segsum(dtA.transpose(-1, -2)))            # (b,nc,h,cs,cs)
    scores = torch.einsum("bctn,bcsn->bcts", Cr, Br)         # (b,nc,cs,cs)
    M = scores[:, :, None] * L                               # (b,nc,h,t,s)
    y_diag = torch.einsum("bchts,bcsh,bcshp->bcthp",
                          _bf(M), _bf(dtr), _bf(xr))

    # --- chunk states: contribution of each chunk to its final state
    # decay from step t (exclusive) to the chunk end: sum_{j>t} dtA_j
    rev_incl = torch.flip(torch.cumsum(torch.flip(dtA, [2]), dim=2), [2])
    decay_to_end = torch.exp(rev_incl - dtA)                 # (b,nc,cs,h)
    states = torch.einsum("bcsn,bcsh,bcshp->bchpn",
                          _bf(Br), _bf(dtr * decay_to_end), _bf(xr))

    # --- inter-chunk recurrence over chunk boundary states
    chunk_decay = torch.exp(dtA.sum(dim=2))                  # (b, nc, h)
    hcur = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    hprevs = []
    for c in range(nc):
        hprevs.append(hcur)
        hcur = hcur * chunk_decay[:, c, :, None, None] + states[:, c]
    hprevs = torch.stack(hprevs, dim=1)                      # (b,nc,h,p,n)

    # --- inter-chunk output: y += C_t · (decay_from_start * h_prev)
    decay_from_start = torch.exp(torch.cumsum(dtA, dim=2))   # (b,nc,cs,h)
    y_off = torch.einsum("bctn,bcth,bchpn->bcthp",
                         _bf(Cr), _bf(decay_from_start), _bf(hprevs))

    y = (y_diag + y_off).reshape(b, s, h, p)
    y = y + x.to(torch.float32) * D[None, None, :, None]
    return y[:, :s0].to(x.dtype), hcur


def mamba2_step(x_t, state: MambaState, dt_t, A_log, B_t, C_t, D):
    """Single-token recurrence. x_t: (b, h, p); dt_t: (b, h); B/C: (b, n)."""
    A = -torch.exp(A_log.to(torch.float32))
    dt = _softplus(dt_t.to(torch.float32))                   # (b, h)
    decay = torch.exp(dt * A[None, :])                       # (b, h)
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt, B_t.to(torch.float32),
                       x_t.to(torch.float32))
    h = state.h * decay[..., None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", C_t.to(torch.float32), h)
    y = y + x_t.to(torch.float32) * D[None, :, None]
    return y.to(x_t.dtype), h


def causal_conv1d(x, w, cache=None):
    """Depthwise causal conv. x: (b, s, c); w: (w_len, c).
    If cache (b, w_len-1, c) given: single-step mode (s==1)."""
    wl = w.shape[0]
    if cache is not None:
        window = torch.cat([cache, x], dim=1)                # (b, wl, c)
        y = torch.einsum("bwc,wc->bc", window.to(torch.float32),
                         w.to(torch.float32))[:, None]
        return y.to(x.dtype), window[:, 1:]
    xp = F.pad(x, (0, 0, wl - 1, 0))
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(wl))
    return y.to(x.dtype), xp[:, x.shape[1]:]  # tail for decode handoff


def _split_in(zxbcdt, d_inner, n):
    return torch.split(zxbcdt, [d_inner, d_inner, n, n,
                                zxbcdt.shape[-1] - 2 * d_inner - 2 * n],
                       dim=-1)


def mamba2_block(params, x, *, n_heads, head_dim, ssm_state, conv_w=4,
                 chunk=128):
    """Full Mamba-2 mixer: in-proj -> conv -> SSD -> gate -> out-proj.
    x: (b, s, d_model) -> (b, s, d_model), final MambaState."""
    b, s, d = x.shape
    d_inner = n_heads * head_dim
    n = ssm_state
    zxbcdt = _dot(x, params["w_in"])          # (b,s, 2*d_inner + 2n + h)
    z, xc, Bc, Cc, dt = _split_in(zxbcdt, d_inner, n)
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)
    conv_out, conv_tail = causal_conv1d(conv_in, params["conv_w"])
    conv_out = F.silu(conv_out)
    xs, Bs, Cs = torch.split(conv_out, [d_inner, n, n], dim=-1)
    y, hlast = ssd_chunked(
        xs.reshape(b, s, n_heads, head_dim), dt, params["A_log"], Bs, Cs,
        params["D"], chunk=chunk)
    y = y.reshape(b, s, d_inner)
    y = rms_norm(y * F.silu(z), params["norm"])
    out = _dot(y, params["w_out"])
    return out, MambaState(h=hlast, conv=conv_tail[:, -(conv_w - 1):])


def mamba2_block_decode(params, x, state: MambaState, *, n_heads, head_dim,
                        ssm_state, conv_w=4):
    """Single-token mixer step. x: (b, 1, d_model)."""
    b, _, d = x.shape
    d_inner = n_heads * head_dim
    n = ssm_state
    zxbcdt = _dot(x, params["w_in"])
    z, xc, Bc, Cc, dt = _split_in(zxbcdt, d_inner, n)
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)
    conv_out, new_conv = causal_conv1d(conv_in, params["conv_w"], state.conv)
    conv_out = F.silu(conv_out)
    xs, Bs, Cs = torch.split(conv_out, [d_inner, n, n], dim=-1)
    y, hnew = mamba2_step(
        xs[:, 0].reshape(b, n_heads, head_dim), state, dt[:, 0],
        params["A_log"], Bs[:, 0], Cs[:, 0], params["D"])
    y = y.reshape(b, 1, d_inner)
    y = rms_norm(y * F.silu(z), params["norm"])
    return _dot(y, params["w_out"]), MambaState(h=hnew, conv=new_conv)


def mamba2_init(generator: torch.Generator, d_model, n_heads, head_dim,
                ssm_state, conv_w=4, device=None):
    d_inner = n_heads * head_dim
    n = ssm_state
    in_dim = 2 * d_inner + 2 * n + n_heads

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device)
    return {
        "w_in": normal((d_model, in_dim)) / math.sqrt(d_model),
        "conv_w": normal((conv_w, d_inner + 2 * n)) * 0.2,
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads,
                                          device=device)),
        "D": torch.ones((n_heads,), dtype=torch.float32, device=device),
        "norm": torch.ones((d_inner,), dtype=torch.float32, device=device),
        "w_out": normal((d_inner, d_model)) / math.sqrt(d_inner),
    }
