"""SEIL-optimized ANNS query pipeline (paper Alg. 2 + Alg. 5).

``seil_search`` composes the four engine stages:

  1. ``select_lists``  — score list centroids, take top-nprobe (ranked);
  2. ``plan_blocks``   — owned / referenced / misc block tables, cell-level
     dedup (the vectorized ``listVisited`` probe), compaction to budget;
  3. ``scan_blocks``   — ADC distances (K1) + item masks, or with
     ``fused_topk`` ``scan_blocks_topk`` (K3: scan, mask and top-fetch
     in one kernel), in exec mode paged, grouped or clustered;
  4. ``finalize_candidates`` — top-bigK (+ id-dedup for layouts without
     SEIL), exact refinement over the original vectors, top-K.

DCO accounting: every valid item in a scanned block counts one ADC
computation (misc duplicates included), skipped reference blocks count
zero, refine adds one exact DCO per unique candidate.  All exec modes,
fused or not, give identical ids and counters.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .engine import (finalize_candidates, plan_blocks, scan_blocks,
                     scan_blocks_topk, select_lists, store_from_arrays,
                     tables_from_arrays)
from .pq import PQCodebook, pq_lut, pq_lut_ip
from .seil import SeilArrays


def finalize_fetch(bigk: int, oversample: int, dedup_results: bool) -> int:
    """The candidate width ``finalize_candidates`` selects before exact
    refinement — the budget a fused scan must deliver."""
    return bigk * (oversample if dedup_results else 1)


class SearchResult(NamedTuple):
    ids: torch.Tensor             # (B, K) int32 final ids (-1 pad)
    dists: torch.Tensor           # (B, K) f32 exact distances
    approx_dco: torch.Tensor      # (B,) int32 ADC distance computations
    refine_dco: torch.Tensor      # (B,) int32 exact distance computations
    scanned_blocks: torch.Tensor  # (B,) int32
    dropped_blocks: torch.Tensor  # (B,) int32 budget overflow (should be 0)


def seil_search(
    arrays: SeilArrays,
    centroids: torch.Tensor,      # (nlist, D)
    codebook: PQCodebook,
    vectors: torch.Tensor,        # (n, D) refine store
    queries: torch.Tensor,        # (B, D)
    *,
    nprobe: int,
    bigk: int,
    k: int,
    max_scan: int,
    metric: str = "l2",
    dedup_results: bool = True,
    oversample: int = 2,
    exec_mode: str = "paged",
    query_tile: int = 8,
    fused_topk: bool = False,
    packed_codes: bool = False,   # arrays carry a nibble-packed plane
) -> SearchResult:
    selection = select_lists(queries, centroids, nprobe=nprobe, metric=metric)
    plan = plan_blocks(tables_from_arrays(arrays), selection,
                       max_scan=max_scan)
    lut = (pq_lut(codebook, queries) if metric == "l2"
           else pq_lut_ip(codebook, queries))                # (B, M, 16)
    store = store_from_arrays(arrays)
    if fused_topk:
        scan = scan_blocks_topk(
            store, plan, lut, selection.rank_of,
            fetch=finalize_fetch(bigk, oversample, dedup_results),
            exec_mode=exec_mode, query_tile=query_tile, sel=selection.sel,
            packed=packed_codes)
    else:
        scan = scan_blocks(store, plan, lut, selection.rank_of,
                           exec_mode=exec_mode, query_tile=query_tile,
                           sel=selection.sel, packed=packed_codes)
    out_ids, out_d, refine_dco = finalize_candidates(
        scan.flat_d, scan.flat_i, bigk=bigk, k=k, vectors=vectors,
        queries=queries, metric=metric, dedup_results=dedup_results,
        oversample=oversample)
    return SearchResult(
        ids=out_ids, dists=out_d, approx_dco=scan.approx_dco,
        refine_dco=refine_dco, scanned_blocks=scan.scanned_blocks,
        dropped_blocks=plan.dropped)
