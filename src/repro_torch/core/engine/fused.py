"""Stage 3+ — fused ADC scan -> stable partial top-``fetch``.

``scan_blocks_topk`` replaces ``scan_blocks`` + ``preselect_candidates``:
its ``ScanOut`` stream is already the stable top-``fetch`` of the plan
layout (ties by flat plan position ``slot * BLK + lane``, masked
entries at ``(+inf, -1)``), and ``approx_dco`` / ``scanned_blocks`` keep
the unfused accounting.  With ``live`` dead candidates are forced out
before selection.

The scan runs through K3 (``kernels/ops.pq_scan_topk``) in every exec
mode; the kernel iterates scan positions (plan slots in paged mode,
sorted-union positions in grouped/clustered), so the plan layout rides
along as two (B, S) sidecars built here: ``slot_of`` (the plan slot at
that position, -1 if the query does not plan it) and ``rank_u`` (its
probe rank).  Callers holding incremental plans pass ``perm`` /
``unions`` as to ``scan_blocks``.
"""
from __future__ import annotations

import torch

from ...kernels import ops
from .cluster import cluster_order, fit_tile, tile_unions, union_dims
from .scan import EXEC_MODES, _safe, batch_union
from .types import BlockStore, QueryPlan, ScanOut


def plan_slot_maps(blocks: torch.Tensor, ranks: torch.Tensor,
                   valid: torch.Tensor, unions: torch.Tensor):
    """Which plan slot does scan position ``w`` of query ``b`` hold?

    blocks/ranks/valid (B, S) in the row order of ``unions`` (T, W),
    B == T * qt.  Returns ``slot_of`` / ``rank_u`` (B, W) int32: the plan
    slot (-1 if absent from that query's plan) and its probe rank.
    Exact because every valid plan block is in its tile's sorted union
    and SEIL plans are per-query duplicate-free.
    """
    b, s = blocks.shape
    t, w = unions.shape
    qt = b // t
    pos = torch.searchsorted(unions.contiguous(),
                             blocks.reshape(t, qt * s).contiguous())
    pos = pos.reshape(b, s)
    # invalid slots scatter into a spare column w, sliced off below
    posc = torch.where(valid, pos.clamp_max(w - 1), torch.full_like(pos, w))
    slots = torch.arange(s, dtype=torch.int32,
                         device=blocks.device).expand(b, s)
    slot_of = torch.full((b, w + 1), -1, dtype=torch.int32,
                         device=blocks.device).scatter_(1, posc, slots)
    rank_u = torch.zeros((b, w + 1), dtype=torch.int32,
                         device=blocks.device).scatter_(1, posc,
                                                        ranks.to(torch.int32))
    return slot_of[:, :w].contiguous(), rank_u[:, :w].contiguous()


def fused_scan_args(store: BlockStore, plan: QueryPlan, lut, rank_of, *,
                    exec_mode: str, query_tile: int, sel, perm=None,
                    unions=None):
    """K3's per-exec-mode inputs: ``(lut, tile_idx, rank_of, slot_of,
    rank_u, query_tile, inv)`` with rows in scan order; ``inv`` (or
    None) restores the batch order of the outputs.  ``perm`` / ``unions``
    as in ``scan_blocks``."""
    b, s = plan.blocks.shape
    if exec_mode == "paged":
        # scan position == plan slot; every query pages its own list
        slots = torch.arange(s, dtype=torch.int32,
                             device=lut.device).expand(b, s)
        slot_of = torch.where(plan.valid, slots, torch.full_like(slots, -1))
        return lut, plan.blocks, rank_of, slot_of, plan.ranks, 1, None
    if exec_mode == "grouped":
        qt = fit_tile(b, query_tile)
        union = (batch_union(plan, store.block_codes.shape[0])
                 if unions is None else unions[0])                # (U,)
        tile_idx = _safe(union)[None, :].expand(b // qt, union.shape[0])
        slot_of, rank_u = plan_slot_maps(plan.blocks, plan.ranks,
                                         plan.valid, union[None, :])
        return lut, tile_idx, rank_of, slot_of, rank_u, qt, None
    # clustered: per-tile unions in probe-overlap order, then un-permute
    perm = (cluster_order(sel) if perm is None else perm).long()
    pb, pr, pv = plan.blocks[perm], plan.ranks[perm], plan.valid[perm]
    if unions is None:
        t, w = union_dims(b, s, store.block_codes.shape[0], "clustered",
                          query_tile)
        unions = tile_unions(pb, pv, t, w)
    t = unions.shape[0]
    slot_of, rank_u = plan_slot_maps(pb, pr, pv, unions)
    return (lut[perm], _safe(unions), rank_of[perm], slot_of, rank_u,
            b // t, torch.argsort(perm))


def scan_blocks_topk(store: BlockStore, plan: QueryPlan, lut: torch.Tensor,
                     rank_of: torch.Tensor, *, fetch: int,
                     exec_mode: str = "paged", query_tile: int = 8, sel=None,
                     perm=None, unions=None, live=None,
                     packed: bool = False) -> ScanOut:
    """Fused scan + stable top-``fetch`` (see the module docstring).
    ``fetch`` is the candidate budget finalize needs (``finalize_fetch``);
    ``perm`` / ``unions`` as in ``scan_blocks``; ``live`` an optional
    tombstone mask over the id space."""
    if exec_mode not in EXEC_MODES:
        raise ValueError(f"exec_mode must be one of {EXEC_MODES}, got "
                         f"{exec_mode!r}")
    s = plan.blocks.shape[1]
    fetch = min(fetch, s * store.block_codes.shape[1])
    dead = None
    if live is not None:
        ids = store.block_ids
        dead = ((ids >= 0) & ~live[ids.clamp_min(0).long()]).to(torch.uint8)
    lut_x, tile_idx, rank_x, slot_of, rank_u, qt, inv = fused_scan_args(
        store, plan, lut, rank_of, exec_mode=exec_mode,
        query_tile=query_tile, sel=sel, perm=perm, unions=unions)
    d, _, ids, dco = ops.pq_scan_topk(
        lut_x, store.block_codes, store.block_ids, store.block_other,
        tile_idx, rank_x, slot_of, rank_u, dead, fetch=fetch, query_tile=qt,
        packed=packed, plan_width=s)
    if inv is not None:
        d, ids, dco = d[inv], ids[inv], dco[inv]
    return ScanOut(flat_d=d, flat_i=ids, approx_dco=dco,
                   scanned_blocks=plan.valid.sum(dim=1).to(torch.int32))
