"""Token-choice top-k MoE with static capacity (GShard-style).

Routing keeps exact top-k semantics: each token picks its top-k experts;
per expert only the first ``capacity`` routed slots are kept (overflow
tokens drop that expert's contribution — standard capacity-factor
behaviour).  Dispatch is a gather and the combine a segment sum, with
fully static shapes.

Both selections are stable, as the reference's are: the top-k takes the
lower expert id first among equal probabilities (a stable descending
sort) and each expert's queue keeps token order (a stable sort by
expert).  The combine sums each token's expert rows in a fixed order
(``core.kmeans.segment_sum``), never with atomics.

Routing has no data-dependent shape: the queue counts come from a
``searchsorted`` over the sorted experts, and the slots are written by
one scatter each, the dropped pairs into a dump slot that is sliced
off.  So the launch tooling traces the MoE stacks on meta tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.kmeans import segment_sum
from .layers import _bmm, _dot_bf16, activation


def route_topk(router_logits: torch.Tensor, k: int, capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """router_logits: (T, E) -> slot assignment.

    Returns (slot_token (E, C) int32 token id or -1,
             slot_gate  (E, C) f32 combine weight,
             aux: load-balance fraction per expert (E,))."""
    t, e = router_logits.shape
    dev = router_logits.device
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = srt.values[:, :k], srt.indices[:, :k]      # (T, k)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    flat_expert = expert.reshape(-1)                          # (T*k,)
    flat_gate = gate.reshape(-1)
    flat_token = torch.repeat_interleave(
        torch.arange(t, dtype=torch.int32, device=dev), k)
    # position of each routed pair within its expert queue; the counts
    # are read off the sorted experts (no bincount: the shapes stay
    # static, so meta tensors trace this too)
    sorted_e, order = torch.sort(flat_expert, stable=True)
    bounds = torch.searchsorted(
        sorted_e, torch.arange(e + 1, dtype=sorted_e.dtype, device=dev))
    counts = bounds[1:] - bounds[:-1]
    starts = bounds[:-1]
    pos_sorted = torch.arange(t * k, device=dev) - starts[sorted_e]
    pos = torch.zeros(t * k, dtype=torch.long, device=dev)
    pos[order] = pos_sorted
    keep = pos < capacity
    # every dropped pair goes to the dump slot e * capacity, which is
    # sliced off: the kept slots are distinct, so each scatter writes
    # every kept slot once and no mask (a data-dependent shape) is needed
    slot = torch.where(keep, flat_expert * capacity + pos, e * capacity)
    slot_token = torch.full((e * capacity + 1,), -1, dtype=torch.int32,
                            device=dev).scatter_(0, slot, flat_token)
    slot_gate = torch.zeros((e * capacity + 1,), dtype=torch.float32,
                            device=dev).scatter_(0, slot, flat_gate)
    load = counts.to(torch.float32) / (t * k)
    return (slot_token[:-1].reshape(e, capacity),
            slot_gate[:-1].reshape(e, capacity), load)


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, act: str = "silu"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d); expert weights (E, d, ff) / (E, ff, d).
    Returns (y (B, S, d) f32, router load (E,))."""
    b, s, d = x.shape
    e = w_gate.shape[0]
    xt = x.reshape(b * s, d)
    logits = _dot_bf16(xt, router_w)                          # bf16 (T, E)
    cap = int(max(top_k * b * s / e * capacity_factor, 4))
    slot_token, slot_gate, load = route_topk(logits.to(torch.float32),
                                             top_k, cap)
    xe = xt[torch.clamp_min(slot_token, 0).long()]            # (E, C, d)
    g = _bmm(xe, w_gate)                                      # (E, C, ff)
    u = _bmm(xe, w_up)
    ye = _bmm((activation(g, act) * u).to(xe.dtype), w_down)  # (E, C, d)
    ye = ye * slot_gate[..., None]
    flat_tok = torch.where(slot_token >= 0, slot_token, b * s).reshape(-1)
    y, _ = segment_sum(ye.reshape(-1, d), flat_tok, b * s + 1)
    return y[:-1].reshape(b, s, d), load
