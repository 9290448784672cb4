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

``zero1`` and ``fsdp`` only steer the shardings
(``train_step_shardings``, resolved as the reference resolves them),
which the launch tooling plans with and the port's one-card step has
no use for; a ``TrainConfig`` means the same in both packages.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..dist.sharding import (NamedSharding, axis_rules, logical_spec,
                             param_shardings, zero1_rules)
from ..models.transformer import (ParamSpec, init_params, param_specs,
                                  train_loss)
from ..optim.adamw import AdamWConfig, OptState, adamw_init, adamw_update
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


def train_step_shardings(cfg: ModelConfig, mesh, tcfg: TrainConfig,
                         batch_specs):
    """(in_shardings, out_shardings) of the train step on ``mesh``:
    ((params, opt state, batch), (params, opt state, metrics)), each a
    tree of `NamedSharding` as the reference's ``jit`` takes them."""
    specs = param_specs(cfg)

    def is_leaf(x):
        return isinstance(x, ParamSpec)

    # a dim is ZeRO-eligible if its logical name resolves to replicated
    replicated = (None, "d_model", "seq", "state", "blk")

    def zero_logical(s: ParamSpec):
        names = list(s.logical)
        # expert/list dims already consume the data axis (2D EP sharding)
        if any(n in ("expert", "lists") for n in names):
            return tuple(names)
        for i, n in enumerate(names):
            if n in replicated and s.shape[i] % mesh.shape["data"] == 0 \
                    and s.shape[i] >= mesh.shape["data"]:
                names[i] = "zero"
                break
        return tuple(names)

    def opt_logical(s: ParamSpec):
        return zero_logical(s) if tcfg.zero1 else s.logical

    o_leaf_sh = param_shardings(specs, mesh, rules=zero1_rules(),
                                is_leaf=is_leaf, logical_of=opt_logical)
    if tcfg.fsdp:
        # ZeRO-3/FSDP: params themselves shard a replicated dim over data
        p_sh = param_shardings(specs, mesh, rules=zero1_rules(),
                               is_leaf=is_leaf, logical_of=zero_logical)
    else:
        p_sh = param_shardings(specs, mesh, is_leaf=is_leaf)
    with axis_rules(mesh):
        scalar = NamedSharding(mesh, ())
        opt_sh = OptState(mu=o_leaf_sh, nu=o_leaf_sh, step=scalar)
        batch_sh = tree_map(
            lambda s: NamedSharding(
                mesh, logical_spec("batch", *([None] * (s.dim() - 1)),
                                   shape=tuple(s.shape))), batch_specs)
        metrics_sh = {"loss": scalar, "grad_norm": scalar, "lr": scalar}
    return (p_sh, opt_sh, batch_sh), (p_sh, opt_sh, metrics_sh)


def init_all(cfg: ModelConfig, generator: torch.Generator,
             device: DeviceLike = None):
    """Random f32 params (``init_params``) and a fresh optimizer state."""
    params = init_params(cfg, generator, resolve_device(device))
    return params, adamw_init(params)
