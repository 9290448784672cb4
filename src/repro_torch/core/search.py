"""SEIL-optimized ANNS query pipeline (paper Alg. 2 + Alg. 5).

``seil_search`` composes the engine stages:

  1. ``select_lists``  — score list centroids, take top-nprobe (ranked);
  2. ``plan_blocks``   — owned / referenced / misc block tables, cell-level
     dedup (the vectorized ``listVisited`` probe), compaction to budget;
  3. ``scan_blocks``   — ADC distances (K1) + item masks, or with
     ``fused_topk`` ``scan_blocks_topk`` (K3: scan, mask and top-fetch
     in one kernel), in exec mode paged, grouped or clustered;
  4. (a stream only) the delta scan — the delta segment's candidates,
     exhaustive or routed through the probed lists
     (``stream/search.py``);
  5. ``finalize_candidates`` — top-bigK (+ id-dedup for layouts without
     SEIL), exact refinement over the original vectors, top-K.

A frozen index passes no stream state.  A stream passes its delta
(``DeltaInputs``), the route choice and its tombstone mask ``live`` over
the id space (base + delta), which forces dead ids to +inf inside
finalize, and with ``fused_topk`` in K3 too (its ``dead`` tile), before
selection; ``vectors`` is then the id-aligned refine store of base and
delta.

Each stage runs in a span with a device fence after it (``obs``): with
no tracer both are no-ops, so the function captures whole into a CUDA
graph and makes no host synchronization; with one (sessions then run
this function eagerly) each span covers its stage's device time and
carries the stage's counters.

DCO accounting: every valid item in a scanned block counts one ADC
computation (misc duplicates included), skipped reference blocks count
zero, each scored delta slot one, refine adds one exact DCO per unique
candidate.  All exec modes, fused or not, give identical ids and
counters.

``probe_plan`` / ``scan_finalize`` are the two halves of a
``plan_reuse`` session (probe -> host plan-cache merge -> scan against
the provided unions), bitwise equal to ``seil_search``; they carry no
spans of their own (the session's dispatch spans them).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import obs
from ..kernels.pq_scan import delta_scan_topk_kernel
from .engine import (PlanProbe, cluster_order, finalize_candidates,
                     plan_blocks, scan_blocks, scan_blocks_topk, select_lists,
                     store_from_arrays, tables_from_arrays, tile_unions,
                     union_dims)
from .pq import PQCodebook, pq_lut, pq_lut_ip
from .seil import SeilArrays
from .stream.search import DeltaInputs, _delta_candidates


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
# the stages; seil_search and the plan_reuse halves are compositions of
# these
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


def _stage_finalize(vectors, queries, scan, dd, di, *, bigk, k, metric,
                    dedup_results, oversample, live):
    """Stage 5 over the base candidates ``scan`` and the delta's ``(dd,
    di)`` (None without a delta)."""
    return finalize_candidates(
        scan.flat_d, scan.flat_i, bigk=bigk, k=k, vectors=vectors,
        queries=queries, metric=metric, dedup_results=dedup_results,
        oversample=oversample, extra_d=dd, extra_i=di, live=live)


def seil_search(
    arrays: SeilArrays,
    centroids: torch.Tensor,      # (nlist, D)
    codebook: PQCodebook,
    vectors: torch.Tensor,        # (n, D) refine store (a stream's: base +
                                  # delta, id-aligned)
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
    delta: Optional[DeltaInputs] = None,
    live: Optional[torch.Tensor] = None,  # (n,) bool tombstone mask
    route_delta: bool = False,
) -> SearchResult:
    """The whole pipeline (module docstring).  Span counters: the scan's
    ``approx_dco`` and ``scanned_blocks``; the delta scan's
    ``delta_dco``, ``kernel`` (1 where the delta scan's kernel ran) and
    on the routed path ``delta_walked`` (posted slots read); finalize's
    ``refine_dco``; each summed over the batch."""
    fetch = finalize_fetch(bigk, oversample, dedup_results)
    count = obs.recording()   # counters are host reads: only while traced
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
            arrays, plan, lut, selection.rank_of, fetch=fetch,
            exec_mode=exec_mode, query_tile=query_tile,
            fused_topk=fused_topk, sel=selection.sel,
            packed_codes=packed_codes, live=live))
        if count:
            sp.add(approx_dco=int(scan.approx_dco.sum()),
                   scanned_blocks=int(scan.scanned_blocks.sum()))
    approx_dco, dd, di = scan.approx_dco, None, None
    if delta is not None:
        with obs.span("stage.delta_scan", cat="device",
                      routed=bool(route_delta)) as sp:
            launches = delta_scan_topk_kernel.launches
            dd, di, delta_dco, walked = obs.fence(_delta_candidates(
                lut, *delta, selection.sel, selection.rank_of, route_delta,
                fetch))
            if count:
                sp.add(delta_dco=int(delta_dco.sum()),
                       kernel=int(delta_scan_topk_kernel.launches > launches))
                if walked is not None:
                    sp.add(delta_walked=int(walked.sum()))
        approx_dco = approx_dco + delta_dco
    with obs.span("stage.finalize", cat="device") as sp:
        out_ids, out_d, refine_dco = obs.fence(_stage_finalize(
            vectors, queries, scan, dd, di, bigk=bigk, k=k,
            metric=metric, dedup_results=dedup_results,
            oversample=oversample, live=live))
        if count:
            sp.add(refine_dco=int(refine_dco.sum()))
    return SearchResult(
        ids=out_ids, dists=out_d, approx_dco=approx_dco,
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
    delta: Optional[DeltaInputs] = None,
    live: Optional[torch.Tensor] = None,
    route_delta: bool = False,
) -> SearchResult:
    """The stages after the plan against caller-provided (possibly
    reused) unions, with a stream's delta and tombstones as in
    ``seil_search``: the delta needs no block planning, so reused plans
    compose with churn unchanged."""
    fetch = finalize_fetch(bigk, oversample, dedup_results)
    scan = _stage_scan(
        arrays, probe.plan, probe.lut, probe.rank_of, fetch=fetch,
        exec_mode=exec_mode, query_tile=query_tile, fused_topk=fused_topk,
        perm=probe.perm, unions=unions, packed_codes=packed_codes,
        live=live)
    approx_dco, dd, di = scan.approx_dco, None, None
    if delta is not None:
        dd, di, delta_dco, _ = _delta_candidates(
            probe.lut, *delta, probe.sel, probe.rank_of, route_delta, fetch)
        approx_dco = approx_dco + delta_dco
    out_ids, out_d, refine_dco = _stage_finalize(
        vectors, queries, scan, dd, di, bigk=bigk, k=k, metric=metric,
        dedup_results=dedup_results, oversample=oversample, live=live)
    return SearchResult(
        ids=out_ids, dists=out_d, approx_dco=approx_dco,
        refine_dco=refine_dco, scanned_blocks=scan.scanned_blocks,
        dropped_blocks=probe.plan.dropped)
