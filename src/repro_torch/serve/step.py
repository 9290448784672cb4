"""Serving steps (prefill / decode / long-context decode) + cache specs.

The specs are meta tensors (shapes and dtypes, no storage) matching the
caches that `models.transformer.prefill` and `models.retrieval` build.

Cache sharding (`cache_shardings`, the reference's production defaults;
the launch tooling plans with them, a step on one card ignores them):
  * KV caches (NP, B, S, kvH, hd): batch over ("pod","data"), head_dim
    over "model" (kvH is often < |model|, hd=128 always divides);
    long-context B=1 caches shard S over "data" instead of batch.
  * Mamba states (NP, B, H, P, N): batch over data, heads over model.
  * RAIRS-kNN caches: block pool over ("pod","data") (like IVF lists),
    head_dim over "model".
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig
from ..dist.sharding import (DEFAULT_RULES, NamedSharding, axis_rules,
                             logical_spec)
from ..models.mamba2 import MambaState
from ..models.retrieval import (KnnAttnConfig, decode_step_long,
                                knn_cache_specs)
from ..models.transformer import decode_step, prefill
from ..tree import tree_map


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _ssm_spec(cfg: ModelConfig, batch: int) -> MambaState:
    np_ = cfg.n_periods
    c = cfg.ssm_heads * cfg.ssm_head_dim + 2 * cfg.ssm_state
    return MambaState(
        h=_meta((np_, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                 cfg.ssm_state), torch.float32),
        conv=_meta((np_, batch, 3, c), torch.float32))


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int,
                kv_dtype=torch.bfloat16) -> Dict:
    """Meta decode cache matching transformer.decode_step's tree."""
    np_ = cfg.n_periods
    kvh, hd = cfg.n_kv_heads, cfg.hd
    blocks = {}
    for j, (mixer, _) in enumerate(cfg.slot_kinds()):
        if mixer == "attn":
            kv = _meta((np_, batch, seq_len, kvh, hd), kv_dtype)
            blocks[f"s{j}"] = (kv, kv)
        else:
            blocks[f"s{j}"] = _ssm_spec(cfg, batch)
    return {"blocks": blocks, "len": _meta((batch,), torch.int32)}


def cache_shardings(cfg: ModelConfig, mesh, cache_tree,
                    long_context: bool = False):
    """NamedShardings for a (possibly knn) cache tree, by leaf shape."""
    hd = cfg.hd

    def shard_leaf(leaf):
        shp = tuple(leaf.shape)
        names = [None] * len(shp)
        if len(shp) >= 2:
            if long_context and len(shp) >= 3 and shp[1] == 1:
                # B=1 long context: shard the big pool/seq dim over data
                big = max(range(1, len(shp)), key=lambda i: shp[i])
                names[big] = "lists"
            else:
                names[1] = "batch"
            if shp[-1] == hd:
                names[-1] = "kv_head_dim"
            elif len(shp) == 5 and shp[2] == cfg.ssm_heads:
                names[2] = "ssm_head"
        with axis_rules(mesh, rules=_cache_rules()):
            return NamedSharding(mesh, logical_spec(*names, shape=shp))

    return tree_map(shard_leaf, cache_tree)


def _cache_rules():
    r = dict(DEFAULT_RULES)
    r["kv_head_dim"] = "model"
    return r


def make_prefill_step(cfg: ModelConfig, cache_slack: int = 0):
    def step(params, batch):
        return prefill(params, cfg, batch, cache_slack=cache_slack)
    return step


def make_decode_step(cfg: ModelConfig):
    def step(params, cache, tokens):
        return decode_step(params, cfg, cache, tokens)
    return step


def make_long_decode_step(cfg: ModelConfig, kcfg: KnnAttnConfig):
    def step(params, cache, tokens):
        return decode_step_long(params, cfg, cache, tokens, kcfg)
    return step


def knn_decode_cache_specs(cfg: ModelConfig, kcfg: KnnAttnConfig,
                           batch: int) -> Dict:
    """Meta long-context cache: knn slots for attention, MambaState
    for ssm slots (matches retrieval.decode_step_long)."""
    slot_specs = knn_cache_specs(cfg, kcfg, batch, cfg.n_periods)
    blocks = {}
    for j, (mixer, _) in enumerate(cfg.slot_kinds()):
        blocks[f"s{j}"] = dict(slot_specs) if mixer == "attn" \
            else _ssm_spec(cfg, batch)
    return {"blocks": blocks, "len": _meta((batch,), torch.int32)}
