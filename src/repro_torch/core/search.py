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

Two cuts of the same composition, each bitwise equal to ``seil_search``:
``seil_search_traced`` runs the four stages with a span and a device
fence at each boundary (sessions dispatch through it while a tracer is
active, ``obs/``), and ``probe_plan`` / ``scan_finalize`` are the two
halves of a ``plan_reuse`` session (probe -> host plan-cache merge ->
scan against the provided unions).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import obs
from .engine import (PlanProbe, cluster_order, finalize_candidates,
                     plan_blocks, scan_blocks, scan_blocks_topk, select_lists,
                     store_from_arrays, tables_from_arrays, tile_unions,
                     union_dims)
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


# ---------------------------------------------------------------------------
# the four stages; seil_search, seil_search_traced and the plan_reuse
# halves are compositions of these
# ---------------------------------------------------------------------------
def _stage_select(centroids, queries, *, nprobe, metric):
    return select_lists(queries, centroids, nprobe=nprobe, metric=metric)


def _stage_plan(arrays, codebook, selection, queries, *, max_scan, metric):
    plan = plan_blocks(tables_from_arrays(arrays), selection,
                       max_scan=max_scan)
    lut = (pq_lut(codebook, queries) if metric == "l2"
           else pq_lut_ip(codebook, queries))                # (B, M, K)
    return plan, lut


def _stage_scan(arrays, plan, lut, rank_of, *, fetch, exec_mode,
                query_tile, fused_topk, sel=None, perm=None, unions=None,
                packed_codes=False, live=None):
    """Stage 3; ``live`` (a tombstone mask, fused only) drops dead ids
    before K3's selection."""
    store = store_from_arrays(arrays)
    if fused_topk:
        return scan_blocks_topk(
            store, plan, lut, rank_of, fetch=fetch, exec_mode=exec_mode,
            query_tile=query_tile, sel=sel, perm=perm, unions=unions,
            live=live, packed=packed_codes)
    return scan_blocks(store, plan, lut, rank_of, exec_mode=exec_mode,
                       query_tile=query_tile, sel=sel, perm=perm,
                       unions=unions, packed=packed_codes)


def _stage_finalize(vectors, queries, flat_d, flat_i, *, bigk, k, metric,
                    dedup_results, oversample):
    return finalize_candidates(
        flat_d, flat_i, bigk=bigk, k=k, vectors=vectors, queries=queries,
        metric=metric, dedup_results=dedup_results, oversample=oversample)


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
    selection = _stage_select(centroids, queries, nprobe=nprobe,
                              metric=metric)
    plan, lut = _stage_plan(arrays, codebook, selection, queries,
                            max_scan=max_scan, metric=metric)
    scan = _stage_scan(
        arrays, plan, lut, selection.rank_of,
        fetch=finalize_fetch(bigk, oversample, dedup_results),
        exec_mode=exec_mode, query_tile=query_tile, fused_topk=fused_topk,
        sel=selection.sel, packed_codes=packed_codes)
    out_ids, out_d, refine_dco = _stage_finalize(
        vectors, queries, scan.flat_d, scan.flat_i, bigk=bigk, k=k,
        metric=metric, dedup_results=dedup_results, oversample=oversample)
    return SearchResult(
        ids=out_ids, dists=out_d, approx_dco=scan.approx_dco,
        refine_dco=refine_dco, scanned_blocks=scan.scanned_blocks,
        dropped_blocks=plan.dropped)


def seil_search_traced(
    arrays: SeilArrays,
    centroids: torch.Tensor,
    codebook: PQCodebook,
    vectors: torch.Tensor,
    queries: torch.Tensor,
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
    packed_codes: bool = False,
) -> SearchResult:
    """Stage-fenced ``seil_search`` for tracing: the same four stages, a
    span and a fence (``torch.cuda.synchronize`` while a tracer is
    active) at each boundary, so each span covers its stage's device
    time.  The span counters carry the stage's DCO."""
    with obs.span("stage.select_lists", cat="device", nprobe=nprobe):
        selection = obs.fence(_stage_select(centroids, queries,
                                            nprobe=nprobe, metric=metric))
    with obs.span("stage.plan_blocks", cat="device", max_scan=max_scan):
        plan, lut = obs.fence(_stage_plan(arrays, codebook, selection,
                                          queries, max_scan=max_scan,
                                          metric=metric))
    name = "stage.scan_blocks_topk" if fused_topk else "stage.scan_blocks"
    with obs.span(name, cat="device", exec_mode=exec_mode) as sp:
        scan = obs.fence(_stage_scan(
            arrays, plan, lut, selection.rank_of,
            fetch=finalize_fetch(bigk, oversample, dedup_results),
            exec_mode=exec_mode, query_tile=query_tile,
            fused_topk=fused_topk, sel=selection.sel,
            packed_codes=packed_codes))
        sp.add(approx_dco=int(scan.approx_dco.sum()),
               scanned_blocks=int(scan.scanned_blocks.sum()))
    with obs.span("stage.finalize", cat="device") as sp:
        out_ids, out_d, refine_dco = obs.fence(_stage_finalize(
            vectors, queries, scan.flat_d, scan.flat_i, bigk=bigk, k=k,
            metric=metric, dedup_results=dedup_results,
            oversample=oversample))
        sp.add(refine_dco=int(refine_dco.sum()))
    return SearchResult(
        ids=out_ids, dists=out_d, approx_dco=scan.approx_dco,
        refine_dco=refine_dco, scanned_blocks=scan.scanned_blocks,
        dropped_blocks=plan.dropped)


# ---------------------------------------------------------------------------
# split pipeline: the two halves of a plan_reuse session
# ---------------------------------------------------------------------------
def probe_plan(
    arrays: SeilArrays,
    centroids: torch.Tensor,
    codebook: PQCodebook,
    queries: torch.Tensor,
    *,
    nprobe: int,
    max_scan: int,
    metric: str = "l2",
    exec_mode: str = "grouped",
    query_tile: int = 8,
) -> PlanProbe:
    """Stages 1-2 + cluster order + this batch's own tile unions."""
    b = queries.shape[0]
    selection = _stage_select(centroids, queries, nprobe=nprobe,
                              metric=metric)
    plan, lut = _stage_plan(arrays, codebook, selection, queries,
                            max_scan=max_scan, metric=metric)
    if exec_mode == "clustered":
        perm = cluster_order(selection.sel)
    else:
        perm = torch.arange(b, dtype=torch.int32, device=queries.device)
    t, w = union_dims(b, plan.blocks.shape[1],
                      arrays.block_codes.shape[0], exec_mode, query_tile)
    p = perm.long()
    unions = tile_unions(plan.blocks[p], plan.valid[p], t, w)
    return PlanProbe(sel=selection.sel, rank_of=selection.rank_of, lut=lut,
                     plan=plan, perm=perm, unions=unions)


def scan_finalize(
    arrays: SeilArrays,
    vectors: torch.Tensor,
    queries: torch.Tensor,
    probe: PlanProbe,
    unions: torch.Tensor,         # (T, W') width-bucketed unions to scan
    *,
    bigk: int,
    k: int,
    metric: str = "l2",
    dedup_results: bool = True,
    oversample: int = 2,
    exec_mode: str = "grouped",
    query_tile: int = 8,
    fused_topk: bool = False,
    packed_codes: bool = False,
) -> SearchResult:
    """Stages 3-4 against caller-provided (possibly reused) unions."""
    scan = _stage_scan(
        arrays, probe.plan, probe.lut, probe.rank_of,
        fetch=finalize_fetch(bigk, oversample, dedup_results),
        exec_mode=exec_mode, query_tile=query_tile, fused_topk=fused_topk,
        perm=probe.perm, unions=unions, packed_codes=packed_codes)
    out_ids, out_d, refine_dco = _stage_finalize(
        vectors, queries, scan.flat_d, scan.flat_i, bigk=bigk, k=k,
        metric=metric, dedup_results=dedup_results, oversample=oversample)
    return SearchResult(
        ids=out_ids, dists=out_d, approx_dco=scan.approx_dco,
        refine_dco=refine_dco, scanned_blocks=scan.scanned_blocks,
        dropped_blocks=probe.plan.dropped)
