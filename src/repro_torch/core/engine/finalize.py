"""Stage 4 — top-bigK candidate selection, id-dedup, exact refinement.

Every selection is a stable ascending sort: equal distances keep the
lower flat position first, the order ``jax.lax.top_k`` gives the
reference.
"""
from __future__ import annotations

import torch

from .types import BIG


def _stable_smallest(d: torch.Tensor, n: int):
    """(values, positions) of the n smallest per row, ascending, ties by
    position."""
    srt = torch.sort(d, dim=1, stable=True)
    return srt.values[:, :n], srt.indices[:, :n]


def preselect_candidates(flat_d, flat_i, *, fetch: int):
    """Stable top-``fetch`` over a flat candidate stream:
    ``(cand_d, cand_ids)`` ascending by distance, ties by flat position."""
    fetch = min(fetch, flat_d.shape[1])
    d, pos = _stable_smallest(flat_d, fetch)
    return d, torch.gather(flat_i, 1, pos)


def score_candidates(cand_ids, cand_ok, vectors, queries, *, metric,
                     vec_lo=None):
    """Exact distances of the candidates, +inf where ``cand_ok`` is
    False.  With ``vec_lo`` the refine store is a row shard holding
    global ids [vec_lo, vec_lo + len(vectors)): only the candidates it
    owns are scored, +inf elsewhere (the sharded tail)."""
    if vec_lo is None:
        cv = vectors[cand_ids.clamp_min(0).long()]            # (B, bigK, D)
        score_ok = cand_ok
    else:
        nloc = vectors.shape[0]
        rel = cand_ids - vec_lo
        score_ok = cand_ok & (rel >= 0) & (rel < nloc)        # owner mask
        cv = vectors[rel.clamp(0, nloc - 1).long()]
    if metric == "l2":
        diff = cv - queries[:, None, :]
        exact = torch.sum(diff * diff, dim=-1)
    else:
        exact = -torch.einsum("bkd,bd->bk", cv, queries)
    return torch.where(score_ok, exact, torch.inf)


def finalize_candidates(flat_d, flat_i, *, bigk, k, vectors, queries,
                        metric, dedup_results, oversample: int = 2,
                        extra_d=None, extra_i=None, live=None,
                        shards=None):
    """Shared tail of the search paths: top-bigK (+ id-dedup for
    duplicated layouts), exact-distance refinement, top-K.

    Duplicated layouts (no SEIL / m-assignment) take ``oversample*bigK``
    candidates before id-dedup so duplicate copies cannot displace
    unique candidates, then truncate to bigK.

    ``extra_d``/``extra_i`` (B, C) are merged into the stream ahead of
    selection; ``live`` (n_total,) bool forces dead ids to +inf before
    selection.  Both are inert when unused.

    ``shards`` (the sharded tail, ``core/distributed.py``) replaces
    ``vectors`` with a sequence of ``(vectors_r, vec_lo_r)`` row shards
    in mesh order, each on its own device: each scores only the
    candidates it owns (``score_candidates``), +inf elsewhere, and the
    exact distances are min-reduced across the shards in mesh order on
    the queries' device (the reference's ``pmin``), so refinement never
    moves vector rows.  One shard with ``vec_lo=0`` is bitwise the
    unsharded path.
    Returns ``(ids (B, k) int32, dists (B, k) f32, refine_dco (B,) int32)``.
    """
    if extra_d is not None:
        flat_d = torch.cat([flat_d, extra_d], dim=1)
        flat_i = torch.cat([flat_i, extra_i], dim=1)
    if live is not None:
        dead = (flat_i >= 0) & ~live[flat_i.clamp_min(0).long()]
        flat_d = torch.where(dead, torch.inf, flat_d)
    bq = flat_d.shape[0]
    fetch = bigk * (oversample if dedup_results else 1)
    fetch = min(fetch, flat_d.shape[1])
    cand_d, pos = _stable_smallest(flat_d, fetch)
    cand_ids = torch.gather(flat_i, 1, pos)                   # (B, fetch)
    cand_ok = torch.isfinite(cand_d)
    if dedup_results:  # layouts without SEIL can hold an id twice
        masked = torch.where(cand_ok, cand_ids, torch.full_like(cand_ids, BIG))
        order = torch.sort(masked, dim=1, stable=True).indices
        sid = torch.gather(cand_ids, 1, order)
        rep = torch.zeros_like(cand_ok)
        rep[:, 1:] = sid[:, 1:] == sid[:, :-1]
        rep_back = torch.zeros_like(rep).scatter_(1, order, rep)
        cand_ok &= ~rep_back
        cand_ok &= torch.cumsum(cand_ok.to(torch.int32), dim=1) <= bigk
    cand_ids = torch.where(cand_ok, cand_ids, torch.full_like(cand_ids, -1))

    if shards is None:
        exact = score_candidates(cand_ids, cand_ok, vectors, queries,
                                 metric=metric)
    else:
        exact = None
        for vecs, lo in shards:
            dev = vecs.device
            e = score_candidates(cand_ids.to(dev), cand_ok.to(dev), vecs,
                                 queries.to(dev), metric=metric,
                                 vec_lo=lo).to(queries.device)
            exact = e if exact is None else torch.minimum(exact, e)
    refine_dco = cand_ok.sum(dim=1).to(torch.int32)
    out_d, posk = _stable_smallest(exact, k)
    out_ids = torch.gather(cand_ids, 1, posk)
    out_ids = torch.where(torch.isfinite(out_d), out_ids,
                          torch.full_like(out_ids, -1))
    return out_ids, out_d, refine_dco
