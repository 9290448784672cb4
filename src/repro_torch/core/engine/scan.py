"""Stage 3 — ADC scan of the planned blocks in one of three exec modes.

``paged``     every query pages its own scan list (K1 at query_tile 1);
``grouped``   the batch-wide sorted union of planned blocks is scored
              once per query tile (K1, one shared list);
``clustered`` queries are permuted into probe-overlap order and each
              query tile scans its own union (K1, per-tile lists).

Grouped and clustered scatter the per-query distances back into the
plan layout through a sorted-union ``searchsorted``, so masks, DCO and
top-k downstream are the same computation as paged and the results are
bitwise identical.  Callers holding incremental plans (``Searcher`` with
``plan_reuse``) pass ``perm`` / ``unions`` explicitly, possibly width-
bucketed and widened with an earlier batch's unions; otherwise both are
derived here.  The scan always goes through ``kernels/ops.py``: on
CUDA tensors that launches the kernel, on CPU tensors the plain version.

Item-level masks (all modes): invalid slots, and misc items whose
co-assigned list was scanned at an earlier rank (Alg. 5 L15-16; their
ADC is still counted into the DCO).
"""
from __future__ import annotations

import torch

from ...kernels import ops
from .cluster import cluster_order, fit_tile, tile_unions, union_dims
from .types import BIG, BlockStore, QueryPlan, ScanOut

EXEC_MODES = ("paged", "grouped", "clustered")


def batch_union(plan: QueryPlan, total_blocks: int) -> torch.Tensor:
    """Sorted union of all valid planned block ids across the batch,
    BIG-padded to the static width min(B*S, TB)."""
    b, s = plan.blocks.shape
    return tile_unions(plan.blocks, plan.valid, 1,
                       min(b * s, total_blocks))[0]


def _safe(u: torch.Tensor) -> torch.Tensor:
    return torch.where(u < BIG, u, torch.zeros_like(u))


def _scan_grouped(store: BlockStore, plan: QueryPlan, lut, query_tile: int,
                  packed: bool, union=None):
    b, s = plan.blocks.shape
    if union is None:
        union = batch_union(plan, store.block_codes.shape[0])   # (U,)
    dists_u = ops.pq_scan_grouped(lut, store.block_codes, _safe(union),
                                  query_tile=fit_tile(b, query_tile),
                                  packed=packed)                # (B, U, BLK)
    pos = torch.searchsorted(union, plan.blocks.reshape(-1)).reshape(b, s)
    pos = pos.clamp_max(union.shape[0] - 1)
    return dists_u[torch.arange(b, device=pos.device)[:, None], pos]


def _scan_clustered(store: BlockStore, plan: QueryPlan, lut, query_tile: int,
                    sel, packed: bool, perm=None, unions=None):
    """Per-tile-union scan in cluster order; returns (B, S, BLK) dists in
    the original batch order."""
    b, s = plan.blocks.shape
    perm = (cluster_order(sel) if perm is None else perm).long()
    pb = plan.blocks[perm]                                      # (B, S)
    if unions is None:
        t, w = union_dims(b, s, store.block_codes.shape[0], "clustered",
                          query_tile)
        unions = tile_unions(pb, plan.valid[perm], t, w)        # (T, W)
    t, w = unions.shape
    qt = b // t
    d_u = ops.pq_scan_tiled(lut[perm], store.block_codes, _safe(unions),
                            query_tile=qt, packed=packed)       # (B, W, BLK)
    pos = torch.searchsorted(unions, pb.reshape(t, qt * s).contiguous())
    pos = pos.reshape(b, s).clamp_max(w - 1)
    dists_p = d_u[torch.arange(b, device=pos.device)[:, None], pos]
    return dists_p[torch.argsort(perm)]


def scan_blocks(store: BlockStore, plan: QueryPlan, lut: torch.Tensor,
                rank_of: torch.Tensor, *, exec_mode: str = "paged",
                query_tile: int = 8, sel=None, perm=None, unions=None,
                packed: bool = False) -> ScanOut:
    """ADC distances + item masks + DCO for the planned blocks.

    lut (B, M, K) per-query tables; rank_of (B, nlist); ``sel`` (the
    stage-1 ranked lists) is required by ``"clustered"`` unless ``perm``
    / ``unions`` (T, W) come from a caller holding incremental plans;
    ``unions`` alone overrides the batch union of ``"grouped"`` (one
    row).  ``packed`` marks ``store.block_codes`` as a nibble-packed
    plane.
    """
    if exec_mode not in EXEC_MODES:
        raise ValueError(f"exec_mode must be one of {EXEC_MODES}, got "
                         f"{exec_mode!r}")
    bq = plan.blocks.shape[0]
    if exec_mode == "grouped":
        dists = _scan_grouped(store, plan, lut, query_tile, packed,
                              union=None if unions is None else unions[0])
    elif exec_mode == "clustered":
        dists = _scan_clustered(store, plan, lut, query_tile, sel, packed,
                                perm=perm, unions=unions)
    else:
        dists = ops.pq_scan_paged(lut, store.block_codes, plan.blocks,
                                  packed=packed)
    blocks = plan.blocks.long()
    ids = store.block_ids[blocks]                  # (B, S, BLK)
    other = store.block_other[blocks]
    o_rank = torch.gather(rank_of, 1, other.clamp_min(0).reshape(bq, -1).long()
                          ).reshape(other.shape)
    dup_item = (other >= 0) & (o_rank < plan.ranks[:, :, None])
    item_ok = (ids >= 0) & plan.valid[:, :, None]
    keep = item_ok & ~dup_item
    # DCO: SEIL computes misc duplicates then discards them (Alg.5 L15-16)
    return ScanOut(
        flat_d=torch.where(keep, dists, torch.inf).reshape(bq, -1),
        flat_i=ids.reshape(bq, -1),
        approx_dco=item_ok.sum(dim=(1, 2)).to(torch.int32),
        scanned_blocks=plan.valid.sum(dim=1).to(torch.int32))
