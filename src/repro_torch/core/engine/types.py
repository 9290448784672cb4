"""Containers exchanged between the engine stages.

The engine decomposes a query batch into four stages:

    select_lists -> ListSelection      (which lists, at which probe rank)
    plan_blocks  -> QueryPlan          (which physical blocks, deduplicated,
                                        compacted to a scan budget)
    scan_blocks  -> ScanOut            (ADC distance per surviving item)
    finalize_candidates                (top-bigK, id-dedup, exact refine)

Each stage is a plain function over these NamedTuples of tensors.  Ids,
ranks and counters are int32 as in the reference; indexing converts to
int64 at the point of use.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 2 ** 30


class ListSelection(NamedTuple):
    """Stage-1 output: ranked probed lists per query."""
    sel: torch.Tensor       # (B, P) int32 list ids, ascending centroid distance
    rank_of: torch.Tensor   # (B, nlist) int32 probe rank, BIG if unselected


class ListTables(NamedTuple):
    """Per-list block tables (the SEIL directory, seil.py)."""
    owned: torch.Tensor        # (nlist, MO) int32 block ids, -1 pad
    owned_other: torch.Tensor  # (nlist, MO) int32 co-list of shared owned blocks
    refs: torch.Tensor         # (nlist, MR) int32 referenced block ids, -1 pad
    refs_other: torch.Tensor   # (nlist, MR) int32 physical-home list, -1 pad
    misc: torch.Tensor         # (nlist, MM) int32 misc block ids, -1 pad


class BlockStore(NamedTuple):
    """Flat physical block storage (plan block ids index into it)."""
    block_codes: torch.Tensor  # (TB, BLK, M) uint8
    block_ids: torch.Tensor    # (TB, BLK) int32, -1 invalid
    block_other: torch.Tensor  # (TB, BLK) int32 co-assigned list, -1 none


class QueryPlan(NamedTuple):
    """Stage-2 output: per-query scan list, compacted to a budget."""
    blocks: torch.Tensor    # (B, S) int32 store-relative block ids (pad -> 0)
    ranks: torch.Tensor     # (B, S) int32 probe rank of each block's scan
    valid: torch.Tensor     # (B, S) bool
    dropped: torch.Tensor   # (B,) int32 candidates lost to the budget


class PlanProbe(NamedTuple):
    """Probe-half output of the split pipeline (``plan_reuse`` sessions,
    core/searcher.py): everything the scan + finalize half consumes, and
    this batch's own tile unions for the host plan cache."""
    sel: torch.Tensor       # (B, P) int32 ranked probed lists
    rank_of: torch.Tensor   # (B, nlist) int32 probe ranks
    lut: torch.Tensor       # (B, M, K) f32 per-query ADC tables
    plan: QueryPlan
    perm: torch.Tensor      # (B,) int32 cluster order (identity for grouped)
    unions: torch.Tensor    # (T, W) int32 sorted tile unions, BIG pad


class ScanOut(NamedTuple):
    """Stage-3 output: flat per-item candidate distances (inf = masked)."""
    flat_d: torch.Tensor          # (B, S*BLK) f32
    flat_i: torch.Tensor          # (B, S*BLK) int32 vector ids
    approx_dco: torch.Tensor      # (B,) int32 ADC distance computations
    scanned_blocks: torch.Tensor  # (B,) int32


def tables_from_arrays(arrays) -> ListTables:
    """ListTables from SeilArrays, deriving ``owned_other`` (the
    co-assigned list of each owned shared block) from block metadata."""
    owned = arrays.owned
    owned_other = arrays.block_other[owned.clamp_min(0).long(), 0]
    owned_other = torch.where(owned >= 0, owned_other,
                              torch.full_like(owned_other, -1))
    return ListTables(owned=owned, owned_other=owned_other, refs=arrays.refs,
                      refs_other=arrays.refs_other, misc=arrays.misc)


def store_from_arrays(arrays) -> BlockStore:
    return BlockStore(block_codes=arrays.block_codes,
                      block_ids=arrays.block_ids,
                      block_other=arrays.block_other)
