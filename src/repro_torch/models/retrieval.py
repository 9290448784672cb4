"""RAIRS-kNN paged attention — the paper's index serving a 500k-token
KV cache (the long_500k cell for full-attention archs).

Keys of each (batch, kv-head) are clustered into `nlist` IVF lists;
each key is redundantly assigned to up to two lists with the AIR metric
(RAIR).  SEIL-for-attention adaptation: every cell_{i,j}'s keys are
packed once into `block`-wide blocks listed in BOTH lists' tables —
attention *must* be compute-once (softmax would double-count a
twice-scanned key), so cell-level deduplication is a correctness
requirement here, done by first-occurrence masking over the gathered
block ids (the vectorized ``listVisited``).  Partial cell blocks are
zero-padded instead of spilling to a misc area.

Decode gathers the top-`nprobe` lists' K/V blocks per kv-head plus a
recent raw window, then does masked attention over ~nprobe·maxb·block
keys instead of the whole cache.  The gathers are plain indexing: the
reference reaches no Pallas kernel here either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch

from ..core.assign import rair_assign
from ..core.kmeans import kmeans_fit
from .layers import (COMPUTE_DTYPE, _attn_scale, _bmm, _dot, apply_rope,
                     attention_proj, rms_norm)
from .transformer import (_index, _mlp_sublayer, _ssm_sublayer,
                          _store_states, _unembed_w, _write_rows)


@dataclasses.dataclass(frozen=True)
class KnnAttnConfig:
    nlist: int = 512
    nprobe: int = 16
    block: int = 128
    max_blocks_per_list: int = 32   # maxb
    window: int = 1024              # recent raw-attention window
    lam: float = 0.5
    n_cands: int = 10
    cache_dtype: str = "bf16"       # bf16 | int8 (per-block absmax scales)


class KnnPackStats(NamedTuple):
    """What packing one slot cache used, per (batch item, kv head) in
    row-major order: blocks allocated of ``nb_cap``, and table entries
    dropped because a list already held ``max_blocks_per_list`` blocks."""
    nb_cap: int
    blocks: Tuple[int, ...]
    dropped: Tuple[int, ...]


def knn_cache_specs(cfg, kcfg: KnnAttnConfig, batch: int, n_periods: int,
                    dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Meta tensors of a per-attn-slot cache (leading period axis)."""
    kvh, hd = cfg.n_kv_heads, cfg.hd
    nb = kcfg.nlist * kcfg.max_blocks_per_list // 2  # RAIR <=2x, shared once
    if kcfg.cache_dtype == "int8":
        dtype = torch.int8

    def S(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    out = {
        "centroids": S((n_periods, batch, kvh, kcfg.nlist, hd),
                       torch.float32),
        "k_blocks": S((n_periods, batch, kvh, nb, kcfg.block, hd), dtype),
        "v_blocks": S((n_periods, batch, kvh, nb, kcfg.block, hd), dtype),
        "key_valid": S((n_periods, batch, kvh, nb, kcfg.block), torch.bool),
        "table": S((n_periods, batch, kvh, kcfg.nlist,
                    kcfg.max_blocks_per_list), torch.int32),
        "win_k": S((n_periods, batch, kcfg.window, kvh, hd), torch.bfloat16),
        "win_v": S((n_periods, batch, kcfg.window, kvh, hd), torch.bfloat16),
    }
    if kcfg.cache_dtype == "int8":  # per-block absmax dequant scales
        out["k_scale"] = S((n_periods, batch, kvh, nb), torch.float32)
        out["v_scale"] = S((n_periods, batch, kvh, nb), torch.float32)
    return out


def probe_lists(qg: torch.Tensor, cents: torch.Tensor, nprobe: int
                ) -> torch.Tensor:
    """The ``nprobe`` lists of highest centroid score for the mean query
    of each GQA group: qg (B, kvH, rep, hd), cents (B, kvH, L, hd) ->
    (B, kvH, nprobe) int64.  A stable descending sort takes the lower
    list first on ties, as the reference's ``top_k`` does."""
    qm = qg.mean(dim=2)                                # (B, kvH, hd)
    cs = (cents.to(torch.float32) @ qm[..., None])[..., 0]
    return torch.sort(cs, dim=-1, descending=True,
                      stable=True).indices[..., :nprobe]


def rairs_attention_decode(q: torch.Tensor, slot_cache: Dict, kv_len,
                           kcfg: KnnAttnConfig) -> torch.Tensor:
    """q: (B, 1, H, hd) -> (B, 1, H, hd) attention over retrieved + window."""
    b, _, h, hd = q.shape
    cents = slot_cache["centroids"]                    # (B, kvH, L, hd)
    kvh = cents.shape[1]
    rep = h // kvh
    qg = q[:, 0].reshape(b, kvh, rep, hd)
    dev = q.device

    # 1. probe lists (group-shared: mean query over the GQA group)
    sel = probe_lists(qg, cents, kcfg.nprobe)          # (B, kvH, P)

    # 2. gather block tables; first-occurrence dedup (vectorized listVisited)
    table = slot_cache["table"]                        # (B,kvH,L,maxb)
    tb = torch.gather(table, 2,
                      sel[..., None].expand(-1, -1, -1, table.shape[-1]))
    ids = tb.reshape(b, kvh, -1)                       # (B,kvH,S)
    s = ids.shape[-1]
    eq = ids[..., :, None] == ids[..., None, :]        # (B,kvH,S,S)
    earlier = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev),
                         diagonal=-1)
    dup = (eq & earlier).any(-1)
    keep_block = (ids >= 0) & ~dup                     # (B,kvH,S)

    # 3. gather K/V blocks (paged)
    safe = torch.clamp_min(ids, 0).long()
    bidx = torch.arange(b, device=dev)[:, None, None]
    gidx = torch.arange(kvh, device=dev)[None, :, None]
    kb = slot_cache["k_blocks"][bidx, gidx, safe]      # (B,kvH,S,blk,hd)
    vb = slot_cache["v_blocks"][bidx, gidx, safe]
    if "k_scale" in slot_cache:     # int8 blocks: per-block absmax dequant
        ks = slot_cache["k_scale"][bidx, gidx, safe]
        vs = slot_cache["v_scale"][bidx, gidx, safe]
        kb = kb.to(COMPUTE_DTYPE) * ks[..., None, None].to(COMPUTE_DTYPE)
        vb = vb.to(COMPUTE_DTYPE) * vs[..., None, None].to(COMPUTE_DTYPE)
    valid = slot_cache["key_valid"][bidx, gidx, safe]  # (B,kvH,S,blk)
    item_mask = valid & keep_block[..., None]

    kf = kb.reshape(b, kvh, -1, hd)
    vf = vb.reshape(b, kvh, -1, hd)
    mask_r = item_mask.reshape(b, kvh, -1)

    # 4. retrieved-set scores + recent window scores, one softmax
    qs = (qg.to(torch.float32) * _attn_scale(hd)).to(COMPUTE_DTYPE)
    sr = _bmm(qs, kf.transpose(-1, -2))                # (B,kvH,rep,K)
    sr = sr.masked_fill(~mask_r[:, :, None], -math.inf)
    wk, wv = slot_cache["win_k"], slot_cache["win_v"]  # (B,W,kvH,hd)
    w = wk.shape[1]
    sw = _bmm(qs, wk.permute(0, 2, 3, 1))              # (B,kvH,rep,W)
    wpos = torch.arange(w, device=dev)[None]
    wmask = wpos < torch.clamp_max(kv_len[:, None], w)
    sw = sw.masked_fill(~wmask[:, None, None], -math.inf)
    p = torch.softmax(torch.cat([sr, sw], dim=-1), dim=-1)
    pr, pw = p[..., :sr.shape[-1]], p[..., sr.shape[-1]:]
    out = _bmm(pr.to(COMPUTE_DTYPE), vf) \
        + _bmm(pw.to(COMPUTE_DTYPE), wv.permute(0, 2, 1, 3))
    return out.reshape(b, 1, h, hd).to(q.dtype)


def update_window(slot_cache: Dict, k_new, v_new, kv_len) -> Dict:
    """Ring-buffer append of the new token's K/V (B,1,kvH,hd) at row
    ``kv_len % window``, written in place."""
    pos = kv_len % slot_cache["win_k"].shape[1]
    _write_rows(slot_cache["win_k"], pos, k_new)
    _write_rows(slot_cache["win_v"], pos, v_new)
    return slot_cache


# ----------------------------------------------------------------------------
# Long-context decode step (the long_500k cell for full-attention archs)
# ----------------------------------------------------------------------------
def decode_step_long(params, cfg, cache, tokens, kcfg: KnnAttnConfig):
    """Like transformer.decode_step, but attention slots run RAIRS-kNN
    paged attention against the clustered cache + recent window.
    tokens: (B, 1); cache["blocks"][s_j] = knn slot dict (attn) or
    MambaState (ssm), period-stacked."""
    h = params["embed"][tokens.long()].to(COMPUTE_DTYPE)
    kv_len = cache["len"]
    kinds = cfg.slot_kinds()
    for p in range(cfg.n_periods):
        pparams = _index(params["blocks"], p)
        pcache = _index(cache["blocks"], p)
        newc = {}
        for j, (mixer, mlp) in enumerate(kinds):
            slot = pparams[f"s{j}"]
            if mixer == "attn":
                x = rms_norm(h, slot["ln1"])
                a = slot["attn"]
                q, k, v = attention_proj(
                    x, a["wq"], a["wk"], a["wv"], cfg.n_heads,
                    cfg.n_kv_heads, cfg.hd, a.get("q_norm"), a.get("k_norm"))
                pos = kv_len[:, None]
                q = apply_rope(q, pos, cfg.rope_theta)
                k = apply_rope(k, pos, cfg.rope_theta)
                sc = update_window(pcache[f"s{j}"], k, v, kv_len)
                o = rairs_attention_decode(q, sc, kv_len + 1, kcfg)
                b = o.shape[0]
                y = _dot(o.reshape(b, 1, cfg.n_heads * cfg.hd), a["wo"])
                h = h + y.to(h.dtype)
            else:
                h, newc[f"s{j}"] = _ssm_sublayer(cfg, slot, h, "decode",
                                                 state=pcache[f"s{j}"])
            if mlp != "none":
                h = _mlp_sublayer(cfg, slot, h, mlp)
        _store_states(cache["blocks"], p, newc)
    h = rms_norm(h, params["final_norm"])
    logits = _dot(h, _unembed_w(params, cfg))
    return logits, {"blocks": cache["blocks"], "len": kv_len + 1}


# ----------------------------------------------------------------------------
# Cache construction: k-means lists + RAIR (AIR) assignment + shared-cell
# packing, on the keys' device
# ----------------------------------------------------------------------------
def knn_centroids(keys: torch.Tensor, kcfg: KnnAttnConfig,
                  seed: int = 0) -> torch.Tensor:
    """(B, S, kvH, hd) keys -> (B, kvH, nlist, hd) f32 centroids: 8
    Lloyd steps per (batch item, kv head) from random rows drawn by a
    CPU generator seeded ``seed + 7*g`` (the same for every batch item,
    as the reference's ``PRNGKey(seed + 7*g)``)."""
    b, _, kvh, _ = keys.shape
    return torch.stack([torch.stack([
        kmeans_fit(keys[bi, :, g].to(torch.float32), kcfg.nlist, iters=8,
                   generator=torch.Generator().manual_seed(seed + 7 * g))
        for g in range(kvh)]) for bi in range(b)])


def pack_knn_cache(keys: torch.Tensor, values: torch.Tensor,
                   centroids: torch.Tensor, kcfg: KnnAttnConfig
                   ) -> Tuple[Dict[str, torch.Tensor], KnnPackStats]:
    """Pack a single-period slot cache against given centroids.

    Each key goes to its RAIR cell (l1, l2); the keys of a cell are
    taken in stable order and packed once into blocks numbered in cell
    order; each block is registered in both lists' tables while the list
    holds fewer than ``max_blocks_per_list`` (the rest are dropped and
    counted).  Raises ``IndexError`` naming ``nb_cap`` if a (batch item,
    kv head) needs more than ``nb_cap`` blocks, where the reference's
    packing loop fails."""
    b, s, kvh, hd = keys.shape
    dev = keys.device
    blk, nlist, maxb = kcfg.block, kcfg.nlist, kcfg.max_blocks_per_list
    nb_cap = nlist * maxb // 2
    kb = torch.zeros((b, kvh, nb_cap, blk, hd), dtype=COMPUTE_DTYPE,
                     device=dev)
    vb = torch.zeros_like(kb)
    valid = torch.zeros((b, kvh, nb_cap, blk), dtype=torch.bool, device=dev)
    table = torch.full((b, kvh, nlist, maxb), -1, dtype=torch.int32,
                       device=dev)
    used, dropped = [], []
    for bi in range(b):
        for g in range(kvh):
            kk = keys[bi, :, g].to(torch.float32)
            a = rair_assign(kk, centroids[bi, g], lam=kcfg.lam,
                            n_cands=min(kcfg.n_cands, nlist)).long()
            cell_key = a[:, 0] * nlist + a[:, 1]
            srt, order = torch.sort(cell_key, stable=True)
            cells, counts = torch.unique_consecutive(srt, return_counts=True)
            nblk = (counts + blk - 1) // blk           # blocks of each cell
            total = int(nblk.sum())
            if total > nb_cap:
                raise IndexError(
                    f"pack_knn_cache: batch item {bi}, kv head {g} needs "
                    f"{total} blocks of {blk} keys, more than nb_cap = "
                    f"{nb_cap} (nlist * max_blocks_per_list / 2)")
            ncell = cells.shape[0]
            cell_of = torch.repeat_interleave(
                torch.arange(ncell, device=dev), counts)
            rank = torch.arange(s, device=dev) - (torch.cumsum(counts, 0)
                                                  - counts)[cell_of]
            bid = (torch.cumsum(nblk, 0) - nblk)[cell_of] + rank // blk
            lane = rank % blk
            kb[bi, g, bid, lane] = kk[order].to(COMPUTE_DTYPE)
            vb[bi, g, bid, lane] = values[bi, order, g].to(COMPUTE_DTYPE)
            valid[bi, g, bid, lane] = True
            # each block in both lists of its cell, blocks in id order
            cell_blk = cells[torch.repeat_interleave(
                torch.arange(ncell, device=dev), nblk)]
            l1, l2 = cell_blk // nlist, cell_blk % nlist
            lists = torch.stack([l1, l2], 1).reshape(-1)
            bids = torch.arange(total, device=dev).repeat_interleave(2)
            two = torch.stack([torch.ones_like(l1, dtype=torch.bool),
                               l2 != l1], 1).reshape(-1)
            lists, bids = lists[two], bids[two]
            by_list, o = torch.sort(lists, stable=True)
            bids = bids[o]
            n_in = torch.bincount(by_list, minlength=nlist)
            slot = torch.arange(by_list.shape[0], device=dev) - (
                torch.cumsum(n_in, 0) - n_in)[by_list]
            fits = slot < maxb
            table[bi, g, by_list[fits], slot[fits]] = bids[fits].to(
                torch.int32)
            used.append(total)
            dropped.append(int((~fits).sum()))
    win = torch.zeros((b, kcfg.window, kvh, hd), dtype=COMPUTE_DTYPE,
                      device=dev)
    cache = {
        "centroids": centroids.to(torch.float32),
        "k_blocks": kb, "v_blocks": vb, "key_valid": valid, "table": table,
        "win_k": win, "win_v": win.clone(),
    }
    return cache, KnnPackStats(nb_cap, tuple(used), tuple(dropped))


def build_knn_cache(keys: torch.Tensor, values: torch.Tensor,
                    kcfg: KnnAttnConfig, seed: int = 0
                    ) -> Tuple[Dict[str, torch.Tensor], KnnPackStats]:
    """keys/values: (B, S, kvH, hd) -> (concrete single-period slot
    cache on their device, what the packing used).  Uses the paper's own
    machinery: k-means lists + RAIR (AIR) assignment + shared-cell
    packing."""
    return pack_knn_cache(keys, values, knn_centroids(keys, kcfg, seed),
                          kcfg)
