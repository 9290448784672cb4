"""Cell planner: (arch x input-shape) -> step fn + meta inputs +
shardings.  The cost pass and the dry-run trace exactly what this module
plans; nothing here allocates memory (meta tensors only).

Skip policy (DESIGN.md §Arch-applicability):
  * hubert (encoder-only): decode_32k / long_500k skipped per spec.
  * long_500k on pure full-attention archs is NOT run as quadratic
    attention (skipped per spec) — instead it runs RAIRS-kNN paged
    attention (the paper's technique), marked mode="rairs_knn".
  * jamba/mamba2 run long_500k natively (O(S)-per-step / O(1)-state).

``SHAPES`` and ``ARCHS`` are this module's names, so a caller may swap
in a smaller shape table or architecture, as the tests do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs import ARCHS
from ..configs.base import SHAPES, ModelConfig
from ..dist.sharding import (NamedSharding, axis_rules, logical_spec,
                             param_shardings)
from ..models.retrieval import KnnAttnConfig
from ..models.transformer import ParamSpec, abstract_params, param_specs
from ..optim.adamw import OptState
from ..serve.step import (cache_shardings, cache_specs, knn_decode_cache_specs,
                          make_decode_step, make_long_decode_step,
                          make_prefill_step)
from ..train.step import TrainConfig, make_train_step, train_step_shardings
from ..tree import tree_map

LONG_KNN_CFG = KnnAttnConfig(nlist=512, nprobe=16, block=128,
                             max_blocks_per_list=24, window=1024)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass
class CellPlan:
    arch: str
    shape: str
    mode: str           # train | prefill | decode | rairs_knn | ssm_long
    step_fn: Any
    args: Tuple                   # meta args
    in_shardings: Tuple
    out_shardings: Any
    note: str = ""


def _batch_specs(cfg: ModelConfig, b: int, s: int, *, labels: bool):
    sp: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "frame":
        sp["frames"] = _meta((b, s, cfg.d_model), torch.bfloat16)
    else:
        sp["tokens"] = _meta((b, s), torch.int32)
        if cfg.frontend == "patch":
            sp["patch_embeds"] = _meta((b, s // 4, cfg.patch_dim),
                                       torch.bfloat16)
        if cfg.m_rope:
            sp["positions3"] = _meta((3, b, s), torch.int32)
    if labels:
        sp["labels"] = _meta((b, s), torch.int32)
    return sp


def _batch_shardings(mesh, batch_specs):
    with axis_rules(mesh):
        def sh(s):
            shape = tuple(s.shape)
            names = [None] * len(shape)
            # batch dim is axis 0 except positions3 (3, B, S)
            bdim = 1 if len(shape) >= 2 and shape[0] == 3 else 0
            names[bdim] = "batch"
            return NamedSharding(mesh, logical_spec(*names, shape=shape))
        return tree_map(sh, batch_specs)


def skip_reason(arch: str, shape: str) -> Optional[str]:
    cfg = ARCHS[arch]
    kind = SHAPES[shape]["kind"]
    if not cfg.has_decode and kind in ("decode", "long_decode"):
        return "encoder-only arch: no decode step (per spec)"
    return None


def plan_cell(arch: str, shape: str, mesh,
              accum: int = 8, grad_compress: str = "none",
              knn_cfg: KnnAttnConfig = None) -> CellPlan:
    cfg = ARCHS[arch]
    info = SHAPES[shape]
    b, s = info["global_batch"], info["seq_len"]
    kind = info["kind"]
    knn_cfg = knn_cfg or LONG_KNN_CFG

    if kind == "train":
        # 400B+ models cannot replicate f32 master params over the data
        # axis -> FSDP/ZeRO-3 sharding
        fsdp = arch in ("arctic-480b", "jamba-1.5-large-398b")
        tcfg = TrainConfig(accum=accum, grad_compress=grad_compress,
                           fsdp=fsdp)
        bs = _batch_specs(cfg, b, s, labels=True)
        params = abstract_params(cfg)
        opt = OptState(
            mu=tree_map(lambda x: _meta(x.shape, torch.float32), params),
            nu=tree_map(lambda x: _meta(x.shape, torch.float32), params),
            step=_meta((), torch.int32))
        (p_sh, o_sh, b_sh), out_sh = train_step_shardings(cfg, mesh, tcfg, bs)
        return CellPlan(arch, shape, "train", make_train_step(cfg, tcfg),
                        (params, opt, bs), (p_sh, o_sh, b_sh), out_sh)

    p_sh = param_shardings(param_specs(cfg), mesh,
                           is_leaf=lambda x: isinstance(x, ParamSpec))
    params = abstract_params(cfg, dtype=torch.bfloat16)

    if kind == "prefill":
        bs = _batch_specs(cfg, b, s, labels=False)
        b_sh = _batch_shardings(mesh, bs)
        return CellPlan(arch, shape, "prefill", make_prefill_step(cfg),
                        (params, bs), (p_sh, b_sh), None)

    if kind == "decode":
        cache = cache_specs(cfg, b, s)
        c_sh = cache_shardings(cfg, mesh, cache)
        toks = _meta((b, 1), torch.int32)
        with axis_rules(mesh):
            t_sh = NamedSharding(mesh, logical_spec("batch", None,
                                                    shape=(b, 1)))
        return CellPlan(arch, shape, "decode", make_decode_step(cfg),
                        (params, cache, toks), (p_sh, c_sh, t_sh),
                        (None, c_sh))

    # ---- long_500k ----
    assert kind == "long_decode"
    toks = _meta((b, 1), torch.int32)
    t_sh = NamedSharding(mesh, ())
    if cfg.attn_every == 0:       # every mixer is full attention
        cache = knn_decode_cache_specs(cfg, knn_cfg, b)
        c_sh = cache_shardings(cfg, mesh, cache, long_context=True)
        return CellPlan(
            arch, shape, "rairs_knn", make_long_decode_step(cfg, knn_cfg),
            (params, cache, toks), (p_sh, c_sh, t_sh), (None, c_sh),
            note="full-attention arch at 524k: RAIRS-kNN paged attention "
                 "(quadratic exact attention skipped per spec)")
    # jamba: native long attention on its sparse attn layers; mamba2: state
    cache = cache_specs(cfg, b, s)
    c_sh = cache_shardings(cfg, mesh, cache, long_context=True)
    return CellPlan(arch, shape, "ssm_long", make_decode_step(cfg),
                    (params, cache, toks), (p_sh, c_sh, t_sh), (None, c_sh),
                    note="SSM/hybrid native long context")


def all_cells():
    for arch in ARCHS:
        for shape in SHAPES:
            yield arch, shape
