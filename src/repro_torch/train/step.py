"""The train step: microbatched gradient accumulation + remat + AdamW.

``make_train_step(cfg, tcfg)`` returns ``train_step(params, opt_state,
batch)``, the reference's step on one device: the global batch is split
into ``tcfg.accum`` microbatches (positions3-style ``(3, B, ...)``
leaves on axis 1), each microbatch's gradient of ``train_loss`` is
summed in f32 and the sum divided by ``accum``, then optionally
compressed and decompressed (``optim/compress.py``), then applied by
``adamw_update``.  A leaf the loss never reads gets a zero gradient (the
reference's ``value_and_grad`` gives zeros; weight decay still moves
it).

``zero1`` and ``fsdp`` only steer the reference's shardings, which the
port's one-card step has no use for; they are kept so a ``TrainConfig``
means the same in both packages.  The shardings themselves
(``train_step_shardings``) come with the launch tooling.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..models.transformer import init_params, train_loss
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..optim.compress import compress_tree, decompress_tree
from ..tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optim: AdamWConfig = AdamWConfig()
    accum: int = 8                   # gradient-accumulation microbatches
    remat: bool = True
    zero1: bool = True
    fsdp: bool = False               # ZeRO-3-style param sharding over data
    grad_compress: str = "none"      # none | bf16 | int8


def split_microbatches(batch, accum: int):
    """The batch's leaves reshaped to (accum, gb/accum, ...): dim 0 is
    the batch, except positions3-style (3, B, ...) leaves (dim 1)."""
    def split(x):
        bdim = 1 if (x.ndim >= 2 and x.shape[0] == 3) else 0
        gb = x.shape[bdim]
        x = x.reshape(x.shape[:bdim] + (accum, gb // accum)
                      + x.shape[bdim + 1:])
        return x.movedim(bdim, 0) if bdim else x
    return tree_map(split, batch)


def accumulate_grads(cfg: ModelConfig, tcfg: TrainConfig, params, batch):
    """(mean loss over the microbatches, the mean gradient as a tree like
    ``params``, f32): each microbatch's gradient summed in f32 into
    zeros, in microbatch order, then divided by ``tcfg.accum``."""
    a = tcfg.accum
    mbs = split_microbatches(batch, a)
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in leaves(params)]
    tot = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for i in range(a):
        req = [p.detach().requires_grad_() for p in leaves(params)]
        loss = train_loss(unflatten(params, req), cfg,
                          tree_map(lambda x: x[i], mbs), remat=tcfg.remat)
        gi = torch.autograd.grad(loss, req, materialize_grads=True)
        with torch.no_grad():
            for g, x in zip(grads, gi):
                g.add_(x)
        tot = tot + loss.detach()
        del req, loss, gi
    for g in grads:
        g.div_(a)
    return tot / a, unflatten(params, grads)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, batch) -> (params', opt',
    {"loss", "grad_norm", "lr"}).  Batch leaves have leading dim
    global_batch (positions3: dim 1)."""

    def train_step(params, opt_state, batch):
        loss, grads = accumulate_grads(cfg, tcfg, params, batch)
        with torch.no_grad():
            if tcfg.grad_compress != "none":
                c, scales = compress_tree(grads, tcfg.grad_compress)
                grads = decompress_tree(c, scales, tcfg.grad_compress)
            new_params, new_opt, om = adamw_update(grads, opt_state, params,
                                                   tcfg.optim)
        return new_params, new_opt, {"loss": loss, **om}

    return train_step


def init_all(cfg: ModelConfig, generator: torch.Generator,
             device: DeviceLike = None):
    """Random f32 params (``init_params``) and a fresh optimizer state."""
    params = init_params(cfg, generator, resolve_device(device))
    return params, adamw_init(params)
