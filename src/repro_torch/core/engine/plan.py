"""Stage 2 — candidate block gathering, cell-level dedup, compaction.

The vectorized form of Alg. 5's ``listVisited`` probe: a reference (or
home shared) block is skipped iff the cell's other list was scanned at
an earlier probe rank.  Surviving candidates are compacted to the scan
budget, keeping owned -> refs -> misc order (each rank-ascending).
``plan_blocks`` can window the candidates to a physical block range and
rebase ids (the sharded layout).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .types import ListSelection, ListTables, QueryPlan


def gather_candidates(tables: ListTables, selection: ListSelection
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query candidate block ids + scan ranks, after cell-level dedup.

    Returns (cand, cand_rank), both (B, P*(MO+MR+MM)); skipped / padded
    entries are -1 in ``cand``.
    """
    sel, rank_of = selection.sel.long(), selection.rank_of
    bq, nprobe = sel.shape
    owned = tables.owned[sel]                      # (B, P, MO)
    owned_other = tables.owned_other[sel]
    refs = tables.refs[sel]                        # (B, P, MR)
    refs_other = tables.refs_other[sel]
    misc = tables.misc[sel]                        # (B, P, MM)
    t = torch.arange(nprobe, dtype=torch.int32,
                     device=sel.device)[None, :, None]

    def visited_earlier(other_list):
        r = torch.gather(rank_of, 1,
                         other_list.clamp_min(0).reshape(bq, -1).long()
                         ).reshape(other_list.shape)
        return (other_list >= 0) & (r < t)

    # reference entries: skip if the home list was scanned earlier (Alg. 5 L7)
    # (a Python -1, not a tensor made from one: that copy from the host
    # would synchronize, and a session captures this stage in a CUDA graph)
    refs = torch.where(visited_earlier(refs_other), -1, refs)
    # home shared blocks: skip if the co-assigned list was scanned earlier
    # (cell-level compute-once in both directions, as the reference does)
    owned = torch.where(visited_earlier(owned_other), -1, owned)

    def flat(tbl):
        return tbl.reshape(bq, -1)

    def ranks_like(tbl):
        return flat(t.expand(tbl.shape))
    cand = torch.cat([flat(owned), flat(refs), flat(misc)], dim=1)
    cand_rank = torch.cat([ranks_like(owned), ranks_like(refs),
                           ranks_like(misc)], dim=1)
    return cand, cand_rank


def compact_plan(cand: torch.Tensor, cand_rank: torch.Tensor, max_scan: int
                 ) -> QueryPlan:
    """Stable compaction of valid candidates to a static budget: valid
    blocks first, then invalid ones, each in position order."""
    max_scan = min(max_scan, cand.shape[1])
    valid = cand >= 0
    n_valid = valid.sum(dim=1).to(torch.int32)
    dropped = torch.clamp_min(n_valid - max_scan, 0).to(torch.int32)
    take = torch.sort((~valid).to(torch.int8), dim=1,
                      stable=True).indices[:, :max_scan]
    blocks = torch.gather(cand, 1, take)                # (B, S)
    ranks = torch.gather(cand_rank, 1, take)            # (B, S)
    bvalid = torch.gather(valid, 1, take)
    return QueryPlan(blocks=blocks.clamp_min(0), ranks=ranks, valid=bvalid,
                     dropped=dropped)


def plan_blocks(tables: ListTables, selection: ListSelection, *,
                max_scan: int, local_lo: Optional[int] = None,
                local_count: Optional[int] = None) -> QueryPlan:
    """Gather + dedup + compact.  With ``local_lo``/``local_count`` the
    candidate set is windowed to physical blocks [lo, lo+count) and ids
    are rebased to the local store."""
    cand, cand_rank = gather_candidates(tables, selection)
    if local_lo is not None:
        rel = cand - local_lo
        mine = (cand >= 0) & (rel >= 0) & (rel < local_count)
        cand = torch.where(mine, rel, torch.full_like(rel, -1))
    return compact_plan(cand, cand_rank, max_scan)
