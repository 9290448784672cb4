"""AdamW with cosine schedule + global-norm clipping, over trees of
tensors (nested dicts, as the LM params are).

The optimizer state carries f32 moments (``OptState``, a ``NamedTuple``
so that its leaves come in the reference's order: mu, nu, step).  The
step, the learning rate and the bias corrections are f32 tensors on the
params' device, computed as the reference computes them, so nothing is
read back to the host inside a step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from ..tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


class OptState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor      # () int32


def adamw_init(params) -> OptState:
    z = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), params)
    dev = leaves(params)[0].device
    return OptState(mu=z, nu=tree_map(torch.clone, z),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def cosine_schedule(cfg: AdamWConfig, step):
    """Linear warmup to ``cfg.lr``, then a cosine to 0 at
    ``total_steps``; f32 from an int (or f32) step tensor."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


def adamw_update(grads, state: OptState, params, cfg: AdamWConfig):
    """-> (new params, new state, {"grad_norm", "lr"}).  One leaf at a
    time, so the transients are one leaf's."""
    step = state.step + 1
    gn = global_norm(grads)
    clip = torch.tensor(cfg.clip_norm, dtype=torch.float32, device=gn.device)
    scale = torch.clamp(clip / torch.clamp_min(gn, 1e-9), max=1.0)
    lr = cosine_schedule(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        return (p - lr * (u + cfg.weight_decay * p)).to(p.dtype), m, v

    out = [upd(*xs) for xs in zip(leaves(params), leaves(grads),
                                  leaves(state.mu), leaves(state.nu))]
    new_params, mu, nu = (unflatten(params, [o[i] for o in out])
                          for i in range(3))
    return new_params, OptState(mu=mu, nu=nu, step=step), \
        {"grad_norm": gn, "lr": lr}
