"""Unified LM stack covering all 10 assigned architectures.

One parameterization, six families:
  dense (llama3/qwen3/gemma), moe (olmoe/arctic), vlm (qwen2-vl, M-RoPE,
  stub patch frontend), audio (hubert encoder, stub frame frontend),
  hybrid (jamba: periods of 7 Mamba + 1 attention, alternating MoE),
  ssm (mamba2, attention-free).

The functional core takes the parameters as a nested dict of tensors,
keyed and period-stacked exactly as the reference's pytree (a leading
``n_periods`` axis on every layer tensor); the stack is a Python loop
over periods that indexes the stacked tensors.  `param_specs` is the
single source of truth for parameter shapes and logical axes:
`init_params` samples real tensors, `abstract_params` gives meta tensors
(full-size weights are never allocated).

Serving dtypes: the reference keeps f32 masters and casts them to bf16
at every product.  `init_params(..., serve_dtype=torch.bfloat16)` (and
`convert.lm_params_from_numpy`) hold in bf16 exactly the tensors named
in `SERVE_CAST`, which only ever reach `_dot`, the router's bf16 product
or the embedding lookup, so the results are unchanged; norm scales,
`A_log`, `D` and `conv_w` stay f32.

Caches are written in place: `decode_step` and `decode_step_long`
update the cache tensors they are given (as a donated buffer is) and
return them with the new length.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from .layers import (COMPUTE_DTYPE, _dot, apply_m_rope, apply_rope,
                     attention_proj, decode_attention, flash_attention,
                     gated_mlp, rms_norm)
from .mamba2 import MambaState, mamba2_block, mamba2_block_decode
from .moe import moe_mlp

# Leaves that only reach `_dot`, the router's bf16 product or the
# embedding lookup: the ones a serving copy may hold in bf16.
SERVE_CAST = frozenset({
    "embed", "unembed", "patch_proj", "wq", "wk", "wv", "wo", "w_gate",
    "w_up", "w_down", "dense_w_gate", "dense_w_up", "dense_w_down",
    "router", "w_in", "w_out"})


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init_scale: Optional[float] = None  # None -> 1/sqrt(fan_in)


def _attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sp = {
        "wq": ParamSpec((d, h * hd), ("d_model", "heads")),
        "wk": ParamSpec((d, kvh * hd), ("d_model", "kv")),
        "wv": ParamSpec((d, kvh * hd), ("d_model", "kv")),
        "wo": ParamSpec((h * hd, d), ("heads", "d_model")),
    }
    if cfg.qk_norm:
        sp["q_norm"] = ParamSpec((hd,), (None,), 1.0)
        sp["k_norm"] = ParamSpec((hd,), (None,), 1.0)
    return sp


def _mlp_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((d, ff), ("d_model", "ff")),
        "w_up": ParamSpec((d, ff), ("d_model", "ff")),
        "w_down": ParamSpec((ff, d), ("ff", "d_model")),
    }


def _moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, e, ff = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff or cfg.d_ff
    sp = {
        "router": ParamSpec((d, e), ("d_model", None)),
        "w_gate": ParamSpec((e, d, ff), ("expert", "d_model", "ff")),
        "w_up": ParamSpec((e, d, ff), ("expert", "d_model", "ff")),
        "w_down": ParamSpec((e, ff, d), ("expert", "ff", "d_model")),
    }
    if cfg.moe_dense_residual:
        for k, v in _mlp_specs(cfg).items():
            sp["dense_" + k] = v
    return sp


def _ssm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_inner = cfg.ssm_heads * cfg.ssm_head_dim
    n = cfg.ssm_state
    in_dim = 2 * d_inner + 2 * n + cfg.ssm_heads
    return {
        "w_in": ParamSpec((d, in_dim), ("d_model", "ssm_head")),
        "conv_w": ParamSpec((4, d_inner + 2 * n), (None, "ssm_head"), 0.2),
        "A_log": ParamSpec((cfg.ssm_heads,), ("ssm_head",), 1.0),
        "D": ParamSpec((cfg.ssm_heads,), ("ssm_head",), 1.0),
        "norm": ParamSpec((d_inner,), ("ssm_head",), 1.0),
        "w_out": ParamSpec((d_inner, d), ("ssm_head", "d_model")),
    }


def param_specs(cfg: ModelConfig):
    """Full parameter tree of ParamSpec (period-stacked layer params)."""
    d = cfg.d_model
    np_ = cfg.n_periods

    def stacked(sp: Dict[str, ParamSpec]):
        return {k: ParamSpec((np_,) + v.shape, (None,) + v.logical,
                             v.init_scale) for k, v in sp.items()}

    blocks: Dict[str, Any] = {}
    for j, (mixer, mlp) in enumerate(cfg.slot_kinds()):
        slot: Dict[str, Any] = {
            "ln1": stacked({"s": ParamSpec((d,), (None,), 1.0)})["s"],
        }
        if mixer == "attn":
            slot["attn"] = stacked(_attn_specs(cfg))
        else:
            slot["ssm"] = stacked(_ssm_specs(cfg))
        if mlp != "none":
            slot["ln2"] = stacked({"s": ParamSpec((d,), (None,), 1.0)})["s"]
            slot["mlp" if mlp == "dense" else "moe"] = stacked(
                _mlp_specs(cfg) if mlp == "dense" else _moe_specs(cfg))
        blocks[f"s{j}"] = slot

    params: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "d_model"), 0.02),
        "blocks": blocks,
        "final_norm": ParamSpec((d,), (None,), 1.0),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = ParamSpec((d, cfg.vocab), ("d_model", "vocab"))
    if cfg.frontend == "patch":
        params["patch_proj"] = ParamSpec((cfg.patch_dim, d),
                                         (None, "d_model"))
    return params


def tree_map(fn, tree, path=()):
    """fn(path, leaf) over a nested dict; path is the tuple of keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], path + (k,)) for k in sorted(tree)}
    return fn(path, tree)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None, serve_dtype=None):
    """Random params from ``generator`` (on ``device``'s type), one
    tensor at a time in sorted key order; each leaf in `SERVE_CAST` is
    cast to ``serve_dtype`` as soon as it is drawn."""
    dev = resolve_device(device)

    def mk(path, s: ParamSpec):
        if s.shape[-1:] == s.shape and s.init_scale == 1.0:
            return torch.ones(s.shape, dtype=torch.float32, device=dev)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        scale = s.init_scale if s.init_scale is not None \
            else 1.0 / math.sqrt(fan_in)
        t = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=dev).mul_(scale)
        if serve_dtype is not None and path[-1] in SERVE_CAST:
            return t.to(serve_dtype)
        return t

    return tree_map(mk, param_specs(cfg))


def abstract_params(cfg: ModelConfig, dtype=torch.float32):
    """Meta tensors of every parameter (serve steps pass bf16)."""
    return tree_map(lambda _, s: torch.empty(s.shape, dtype=dtype,
                                             device="meta"),
                    param_specs(cfg))


def param_logical(cfg: ModelConfig):
    return tree_map(lambda _, s: s.logical, param_specs(cfg))


def _index(tree, p: int):
    """Period p of a period-stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, p) for k, v in tree.items()}
    if isinstance(tree, MambaState):
        return MambaState(*(t[p] for t in tree))
    if isinstance(tree, tuple):
        return tuple(t[p] for t in tree)
    return tree[p]


def _unbind(tree, n: int):
    """The n periods of a period-stacked tree of tensors, each leaf
    unbound once: under a gradient, one backward node stacks the n
    periods' gradients, where n indexings would each add a zero-filled
    full-size gradient."""
    if isinstance(tree, dict):
        per = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: v[p] for k, v in per.items()} for p in range(n)]
    return list(torch.unbind(tree))


# ----------------------------------------------------------------------------
# Embedding / frontend
# ----------------------------------------------------------------------------
def embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    if cfg.frontend == "frame":
        h = batch["frames"]                      # (B, S, d) stub frontend
    else:
        h = params["embed"][batch["tokens"].long()]  # (B, S, d)
        if cfg.frontend == "patch":
            pe = _dot(batch["patch_embeds"], params["patch_proj"])
            p = pe.shape[1]
            h = torch.cat([pe.to(h.dtype), h[:, p:]], dim=1)
    return h.to(COMPUTE_DTYPE)


def _positions(cfg, batch, h):
    b, s = h.shape[:2]
    if cfg.m_rope:
        return batch["positions3"]               # (3, B, S)
    return torch.arange(s, dtype=torch.int32,
                        device=h.device)[None].expand(b, s)


# ----------------------------------------------------------------------------
# Sublayers
# ----------------------------------------------------------------------------
def _rope(cfg, x, pos):
    if cfg.m_rope:
        return apply_m_rope(x, pos, cfg.m_rope_sections, cfg.rope_theta)
    return apply_rope(x, pos, cfg.rope_theta)


def _write_rows(buf, rows, val):
    """buf[i, rows[i]] = val[i, 0] for every batch row i (one indexed
    write, the reference's ``dynamic_update_slice`` under ``vmap``)."""
    bidx = torch.arange(buf.shape[0], device=buf.device)
    buf[bidx, rows.long()] = val[:, 0].to(buf.dtype)


def _attn_sublayer(cfg, p, h, pos, mode, cache_kv=None, cache_len=None):
    x = rms_norm(h, p["ln1"])
    a = p["attn"]
    q, k, v = attention_proj(x, a["wq"], a["wk"], a["wv"], cfg.n_heads,
                             cfg.n_kv_heads, cfg.hd,
                             a.get("q_norm"), a.get("k_norm"))
    if mode == "decode":
        qpos = cache_len[:, None]
        if cfg.m_rope:
            qpos = qpos[None].expand((3,) + qpos.shape)
        q = _rope(cfg, q, qpos)
        k = _rope(cfg, k, qpos)
        kc, vc = cache_kv
        smax = kc.shape[1]
        upd = torch.clamp_max(cache_len, smax - 1)
        _write_rows(kc, upd, k)
        _write_rows(vc, upd, v)
        o = decode_attention(q, kc, vc, cache_len + 1)
        new_cache = (kc, vc)
    else:
        q = _rope(cfg, q, pos)
        k = _rope(cfg, k, pos)
        o = flash_attention(q, k, v, causal=cfg.causal,
                            chunk=min(cfg.flash_chunk, q.shape[1]))
        new_cache = (k, v)
    b, s = o.shape[:2]
    y = _dot(o.reshape(b, s, cfg.n_heads * cfg.hd), a["wo"])
    return h + y.to(h.dtype), new_cache


def _mlp_sublayer(cfg, p, h, kind):
    x = rms_norm(h, p["ln2"])
    if kind == "dense":
        m = p["mlp"]
        y = gated_mlp(x, m["w_gate"], m["w_up"], m["w_down"], cfg.act)
        return h + y.to(h.dtype)
    m = p["moe"]
    y, _load = moe_mlp(x, m["router"], m["w_gate"], m["w_up"], m["w_down"],
                       top_k=cfg.moe_top_k,
                       capacity_factor=cfg.capacity_factor, act=cfg.act)
    if cfg.moe_dense_residual:
        y = y + gated_mlp(x, m["dense_w_gate"], m["dense_w_up"],
                          m["dense_w_down"], cfg.act)
    return h + y.to(h.dtype)


def _ssm_sublayer(cfg, p, h, mode, state: Optional[MambaState] = None):
    x = rms_norm(h, p["ln1"])
    if mode == "decode":
        y, new_state = mamba2_block_decode(
            p["ssm"], x, state, n_heads=cfg.ssm_heads,
            head_dim=cfg.ssm_head_dim, ssm_state=cfg.ssm_state)
    else:
        y, new_state = mamba2_block(
            p["ssm"], x, n_heads=cfg.ssm_heads, head_dim=cfg.ssm_head_dim,
            ssm_state=cfg.ssm_state, chunk=min(cfg.ssm_chunk, x.shape[1]))
    return h + y.to(h.dtype), new_state


# ----------------------------------------------------------------------------
# Stack
# ----------------------------------------------------------------------------
class _Stacker:
    """Gathers each period's cache into period-stacked tensors, written
    into buffers allocated at the first period (axis 2 of an attention
    cache padded by ``slack`` zero rows), so no second copy is made."""

    def __init__(self, n_periods: int, slack: int = 0):
        self.np_, self.slack, self.out = n_periods, slack, {}

    def _buf(self, like, pad):
        shape = list(like.shape)
        if pad:
            shape[1] += self.slack
        return torch.zeros((self.np_, *shape), dtype=like.dtype,
                           device=like.device)

    def put(self, name, p, cache):
        if isinstance(cache, MambaState):
            if name not in self.out:
                self.out[name] = MambaState(*(self._buf(t, False)
                                              for t in cache))
        elif name not in self.out:
            self.out[name] = tuple(self._buf(t, True) for t in cache)
        for buf, t in zip(self.out[name], cache):
            buf[p, :, :t.shape[1]] = t


def _period_fn(cfg: ModelConfig, mode: str):
    kinds = cfg.slot_kinds()

    def run(h, pos, pparams, pcache, cache_len):
        new_cache = {}
        for j, (mixer, mlp) in enumerate(kinds):
            slot = pparams[f"s{j}"]
            st = pcache.get(f"s{j}") if pcache else None
            if mixer == "attn":
                h, c = _attn_sublayer(cfg, slot, h, pos, mode,
                                      cache_kv=st, cache_len=cache_len)
            else:
                h, c = _ssm_sublayer(cfg, slot, h, mode, state=st)
            new_cache[f"s{j}"] = c
            if mlp != "none":
                h = _mlp_sublayer(cfg, slot, h, mlp)
        return h, new_cache

    return run


def _forward(params, cfg: ModelConfig, batch, mode: str, slack: int = 0,
             remat: bool = False):
    """The stack.  In train mode no cache is stacked (the reference's is
    dead code that XLA drops), and with ``remat`` under a gradient each
    period is checkpointed: its activations are recomputed in the
    backward pass, as ``jax.checkpoint`` over the scanned body does."""
    h = embed_inputs(params, cfg, batch)
    pos = _positions(cfg, batch, h)
    run = _period_fn(cfg, mode)
    if mode == "train":
        def body(hh, pparams):
            return run(hh, pos, pparams, None, None)[0]
        for pp in _unbind(params["blocks"], cfg.n_periods):
            if remat and torch.is_grad_enabled():
                h = checkpoint(body, h, pp, use_reentrant=False)
            else:
                h = body(h, pp)
        return rms_norm(h, params["final_norm"]), {}
    stack = _Stacker(cfg.n_periods, slack)
    for p in range(cfg.n_periods):
        h, cache = run(h, pos, _index(params["blocks"], p), None, None)
        for name, c in cache.items():
            stack.put(name, p, c)
        del cache
    return rms_norm(h, params["final_norm"]), stack.out


def forward(params, cfg: ModelConfig, batch, mode: str = "train",
            remat: bool = True):
    """Runs the stack. Returns (hidden (B,S,d), per-period cache stack);
    train mode returns an empty cache.  ``remat`` checkpoints each period
    in train mode when a gradient is taken."""
    return _forward(params, cfg, batch, mode, remat=remat)


# ----------------------------------------------------------------------------
# Losses / serving entry points
# ----------------------------------------------------------------------------
def _chunked_ce(h, w_unembed, labels, chunk: int):
    """Cross entropy with sequence chunking: (loss sum, label count)."""
    b, s, d = h.shape
    nch = max(s // chunk, 1)
    hs = h.reshape(b, nch, s // nch, d)
    ls = labels.reshape(b, nch, s // nch)
    tot = torch.zeros(2, dtype=torch.float32, device=h.device)
    for c in range(nch):
        hc, lc = hs[:, c], ls[:, c]             # (b, c, d), (b, c)
        logits = _dot(hc, w_unembed)            # (b, c, V) f32
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, torch.clamp_min(lc, 0).long()[..., None]
                            )[..., 0]
        mask = (lc >= 0).to(torch.float32)
        loss = ((lse - gold) * mask).sum()
        tot = tot + torch.stack([loss, mask.sum()])
    return tot


def _unembed_w(params, cfg):
    return params["unembed"] if not cfg.tie_embeddings else params["embed"].T


def train_loss(params, cfg: ModelConfig, batch, remat: bool = True):
    """Mean next-token cross entropy over the labels >= 0; differentiable
    (``train/step.py`` takes its gradient), each period checkpointed
    when ``remat``."""
    h, _ = _forward(params, cfg, batch, mode="train", remat=remat)
    acc = _chunked_ce(h, _unembed_w(params, cfg), batch["labels"],
                      cfg.ce_chunk)
    return acc[0] / torch.clamp_min(acc[1], 1.0)


def prefill(params, cfg: ModelConfig, batch, cache_slack: int = 0):
    """Returns (last-position logits, decode cache).  The attention
    caches are f32 (``_dot``'s result), padded by ``cache_slack``."""
    h, cache = _forward(params, cfg, batch, mode="prefill",
                        slack=cache_slack)
    b, s = h.shape[:2]
    logits = _dot(h[:, -1:], _unembed_w(params, cfg))
    if cfg.has_decode:
        length = torch.full((b,), s, dtype=torch.int32, device=h.device)
        return logits, {"blocks": cache, "len": length}
    return logits, None


def _store_states(blocks, p, new_cache):
    """Write period p's new Mamba states into the stacked cache (the
    attention rows were written in place)."""
    for name, c in new_cache.items():
        if isinstance(c, MambaState):
            for buf, t in zip(blocks[name], c):
                buf[p] = t


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """tokens: (B, 1) -> (logits (B,1,V), updated cache)."""
    h = params["embed"][tokens.long()].to(COMPUTE_DTYPE)
    run = _period_fn(cfg, "decode")
    cache_len = cache["len"]
    for p in range(cfg.n_periods):
        h, newc = run(h, None, _index(params["blocks"], p),
                      _index(cache["blocks"], p), cache_len)
        _store_states(cache["blocks"], p, newc)
    h = rms_norm(h, params["final_norm"])
    logits = _dot(h, _unembed_w(params, cfg))
    return logits, {"blocks": cache["blocks"], "len": cache_len + 1}


class Model(torch.nn.Module):
    """Thin ``nn.Module`` veneer used by examples and launchers: it
    registers the parameter tree (gradient-free parameters under the
    tree's keys) and calls the functional core on it."""

    def __init__(self, cfg: ModelConfig, params=None):
        super().__init__()
        self.cfg = cfg
        self.tree = None if params is None else _Tree(params)

    def init(self, generator: torch.Generator, device: DeviceLike = None,
             serve_dtype=None):
        params = init_params(self.cfg, generator, device, serve_dtype)
        self.tree = _Tree(params)
        return params

    def params(self):
        return self.tree.as_dict()

    def loss(self, batch):
        return train_loss(self.params(), self.cfg, batch)

    def prefill(self, batch, cache_slack=0):
        return prefill(self.params(), self.cfg, batch, cache_slack)

    def decode(self, cache, tokens):
        return decode_step(self.params(), self.cfg, cache, tokens)


class _Tree(torch.nn.Module):
    """One dict level of the parameter tree as a module."""

    def __init__(self, tree):
        super().__init__()
        self.keys = sorted(tree)
        for k in self.keys:
            if isinstance(tree[k], dict):
                self.add_module(k, _Tree(tree[k]))
            else:
                self.register_parameter(
                    k, torch.nn.Parameter(tree[k], requires_grad=False))

    def as_dict(self):
        out = {}
        for k in self.keys:
            v = getattr(self, k)
            out[k] = v.as_dict() if isinstance(v, _Tree) else v.data
        return out
