"""Streaming query pipeline: base engine stages + delta scan + tombstones
(counterpart of ``repro/core/stream/search.py``).

``streaming_search`` runs the four engine stages of ``seil_search`` over
the immutable base layout and extends the candidate stream with the
mutable epoch state before the shared finalize stage:

  * the **delta segment** is scanned in one of two ways.  While its
    capacity is at most the routing threshold (``IndexConfig.
    delta_route_min``, default ``nlist * block``) every live slot gets one
    ADC distance per query (exhaustive).  Above it the scan is **routed**:
    each probed list contributes the delta slots posted under it
    (``DeltaSegment.post``), each slot scored once, at its lowest-ranked
    probed assigned list (the delta side of ``listVisited``).  Delta
    candidates enter ``finalize_candidates`` through ``extra_d`` /
    ``extra_i`` and compete with the base's under the same top-bigK and
    refinement rules;
  * the **tombstone mask** ``live`` (over the id space, base + delta)
    forces dead ids to +inf inside finalize, and with ``fused_topk`` in
    K3 too (its ``dead`` tile), before selection.

DCO: the exhaustive path counts one ADC distance per live slot per
query, the routed path one per live slot reachable through the probed
lists; dead slots cost nothing.

The routed scan with its top-``fetch`` cut is one hand-written kernel on
the card (``kernels/ops.py::delta_scan_topk``, ``csrc/delta_scan_topk.cu``):
a CTA a query walks each probed list's postings up to its first pad and
scores only the kept slots against the query's table in shared memory,
over ascending m as K1 sums, keeping the stable top-``fetch``.  Its plain
version (``routed_delta_topk``, the CPU's path) and the exhaustive scan
(on every device; the reference's is plain JAX, no Pallas) are torch
gather-and-sums.  The exhaustive scan, whose codes every query shares,
is one ``F.embedding_bag(mode="sum")`` a chunk: a bag a slot over its M
rows of the chunk's (M * K, B) table, added in order from zero
(``chip_smoke.py`` holds it bitwise against a loop of one gather and one
add per m on the card, and ``tools/delta_scan_chunks.py`` times both:
4.2x faster at capacity 131,072).  The plain routed scan, whose rows
differ by query, runs that loop.  The reference materialises (B, C, M)
lookups; the plain versions cut the batch into query chunks of at most
``DELTA_CHUNK_BYTES`` (256 MiB) of working set, counted from the
temporaries each chunk holds at once (exhaustive: 40 bytes a query and
slot, the f32 sums, their masked copy and the int64 selection keys;
routed: ``P * L * (2 M + 16 m + 48)`` bytes a query, the gathered code
rows, the assigned lists' ranks, the sums and the keys), so their peak
stays near 256 MiB at any batch and capacity; the kernel holds no such
temporaries.  Each query keeps only its stable top-``fetch`` delta
candidates (``fetch`` the finalize budget, ``finalize_fetch``):
finalize's stable selection over the base stream followed by the delta
stream gives the same candidates from those alone, in the same order, so
the results are the reference's.

``scan_finalize_stream`` is the streaming scan half of a ``plan_reuse``
session (the counterpart of ``core/search.py::scan_finalize``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import obs
from ...kernels import ops
from ...kernels.pq_scan import delta_scan_topk_kernel
from ..engine import (PlanProbe, finalize_candidates, plan_blocks,
                      scan_blocks, scan_blocks_topk, select_lists,
                      store_from_arrays, tables_from_arrays)
from ..pq import PQCodebook, pq_lut, pq_lut_ip
from ..search import (SearchResult, _stage_plan, _stage_scan, _stage_select,
                      finalize_fetch)
from ..seil import SeilArrays

DELTA_CHUNK_BYTES = 2 ** 28


def _rows_per_chunk(b: int, bytes_per_query: int) -> int:
    return max(1, min(b, DELTA_CHUNK_BYTES // max(1, bytes_per_query)))


def _table_index(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(C, M) codes as int64 rows of an (M * K)-row table: m * K + code."""
    m = codes.shape[1]
    return codes.long() + torch.arange(m, device=codes.device) * k


def _adc_columns(lut: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """sum_m lut[b, m, codes[c, m]] over ascending m for codes shared by
    every query, given as ``_table_index`` rows: (B, M, K) x (C, M) ->
    (B, C) f32."""
    b, m, k = lut.shape
    table = lut.reshape(b, m * k).t().contiguous()          # (M*K, B)
    return F.embedding_bag(index, table, mode="sum").t()


def _adc_rows(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """sum_m lut[b, m, codes[b, n, m]] over ascending m: (B, M, K) x
    (B, N, M) uint8 rows of each query's own -> (B, N) f32, one gather
    and one add per m."""
    b, n, m = codes.shape
    codes_t = codes.permute(2, 0, 1).contiguous()           # (M, B, N)
    out = torch.zeros((b, n), dtype=torch.float32, device=lut.device)
    for j in range(m):
        out.add_(torch.gather(lut[:, j, :], 1, codes_t[j].long()))
    return out


def delta_adc(lut: torch.Tensor, delta_codes: torch.Tensor) -> torch.Tensor:
    """ADC distances of every delta slot: (B, M, K) lut x (C, M) codes
    -> (B, C).  d[b, c] = sum_m lut[b, m, codes[c, m]], ascending m."""
    return _adc_columns(lut, _table_index(delta_codes, lut.shape[2]))


def _stable_top(d: torch.Tensor, i: torch.Tensor, n: int):
    """The stable top-``n`` of each row of ``d`` (ascending, ties by
    position) and its ``i``: a unique int64 key (the f32 bits made
    signed-monotone in [-2**31, 2**31), -0.0 taken as +0.0, above the
    column) makes ``torch.topk`` exact for either sign of distance."""
    n = min(n, d.shape[1])
    bits = (d + 0.0).view(torch.int32).long()
    mono = torch.where(bits >= 0, bits, -2 ** 31 - bits)
    col = torch.arange(d.shape[1], dtype=torch.long, device=d.device)
    key = torch.topk((mono << 32) | col, n, dim=1, largest=False,
                     sorted=True).values
    pos = key & 0xFFFFFFFF
    return torch.gather(d, 1, pos), torch.gather(i, 1, pos)


def _routed_rows(lut, delta_codes, delta_ids, delta_post, delta_assigns,
                 sel, rank_of):
    """``routed_delta_candidates`` for one chunk of queries."""
    b, p = sel.shape
    slots = delta_post[sel.long()]                          # (B, P, L)
    s0 = slots.clamp_min(0).long()
    sids = torch.where(slots >= 0, delta_ids[s0], torch.full_like(slots, -1))
    al = delta_assigns[s0]                                  # (B, P, L, m)
    r = torch.gather(rank_of, 1, al.reshape(b, -1).long()).reshape(al.shape)
    min_rank = r.min(dim=-1).values                         # (B, P, L)
    keep = (sids >= 0) & (min_rank == torch.arange(
        p, dtype=torch.int32, device=sel.device)[None, :, None])
    d = _adc_rows(lut, delta_codes[s0.reshape(b, -1)])      # (B, P*L)
    keep = keep.reshape(b, -1)
    sids = sids.reshape(b, -1)
    dd = torch.where(keep, d, torch.inf)
    di = torch.where(keep, sids, torch.full_like(sids, -1))
    return dd, di, keep.sum(dim=1).to(torch.int32)


def _routed_bytes(delta_post, delta_codes, delta_assigns, p) -> int:
    return p * delta_post.shape[1] * (2 * delta_codes.shape[1]
                                      + 16 * delta_assigns.shape[1] + 48)


def _routed_chunks(lut, delta_codes, delta_ids, delta_post, delta_assigns,
                   sel, rank_of, fetch=None):
    """``_routed_rows`` over query chunks (module docstring), each
    chunk's stream cut to its stable top-``fetch`` when one is given."""
    b, p = sel.shape
    step = _rows_per_chunk(b, _routed_bytes(delta_post, delta_codes,
                                            delta_assigns, p))
    dds, dis, dcos = [], [], []
    for s in range(0, b, step):
        dd, di, dco = _routed_rows(
            lut[s:s + step], delta_codes, delta_ids, delta_post,
            delta_assigns, sel[s:s + step], rank_of[s:s + step])
        if fetch is not None:
            dd, di = _stable_top(dd, di, fetch)
        dds.append(dd)
        dis.append(di)
        dcos.append(dco)
    return torch.cat(dds), torch.cat(dis), torch.cat(dcos)


def routed_delta_candidates(lut, delta_codes, delta_ids, delta_post,
                            delta_assigns, sel, rank_of):
    """Delta candidates reached through the probed lists only.

    lut (B, M, K); delta_post (nlist, L) slot ids (-1 pad);
    delta_assigns (cap, m); sel (B, P) ranked probed lists; rank_of
    (B, nlist).  Returns ``(dd, di, dco)``: (B, P*L) distances / ids and
    the per-query routed DCO.  A slot assigned to several probed lists is
    scored once, at its lowest-ranked probed assigned list, so the
    candidate stream stays duplicate-free.  Computed in query chunks
    (module docstring)."""
    return _routed_chunks(lut, delta_codes, delta_ids, delta_post,
                          delta_assigns, sel, rank_of)


def routed_delta_topk(lut, delta_codes, delta_ids, delta_post,
                      delta_assigns, sel, rank_of, fetch: int):
    """The plain version of ``kernels/pq_scan.py::delta_scan_topk_kernel``
    (the CPU's routed delta scan): ``routed_delta_candidates`` with each
    query's stream cut to its stable top-``fetch`` in query chunks, and
    the posted slots each query reads.  Returns ``(dd, di, dco,
    walked)``."""
    dd, di, dco = _routed_chunks(lut, delta_codes, delta_ids, delta_post,
                                 delta_assigns, sel, rank_of, fetch)
    walked = (delta_post[sel.long()] >= 0).sum(dim=(1, 2), dtype=torch.int32)
    return dd, di, dco, walked


def _delta_candidates(lut, delta_codes, delta_ids, delta_post,
                      delta_assigns, sel, rank_of, route_delta: bool,
                      fetch: int):
    """``(dd, di, per-query delta DCO, walked)`` through the routed scan
    (``ops.delta_scan_topk``: the kernel on the card; ``walked`` the
    posted slots each query read) or the exhaustive one (``walked``
    None), each query's stream cut to its stable top-``fetch``."""
    if route_delta:
        return ops.delta_scan_topk(lut, delta_codes, delta_ids, delta_post,
                                   delta_assigns, sel, rank_of, fetch=fetch)
    return (*exhaustive_delta_candidates(lut, delta_codes, delta_ids, fetch),
            None)


def exhaustive_delta_candidates(lut, delta_codes, delta_ids, fetch: int):
    """Every live slot of ``delta_codes`` / ``delta_ids`` (-1: dead or
    unused) scored for every query, each query's stream cut to its
    stable top-``fetch`` in query chunks (module docstring): ``(dd, di,
    per-query delta DCO)``.  A mesh shard passes its own slots
    (``core/distributed.py``)."""
    b = lut.shape[0]
    alive = delta_ids >= 0                                  # (cap,)
    cap = delta_ids.shape[0]
    index = _table_index(delta_codes, lut.shape[2])        # (cap, M)
    ids = delta_ids[None, :]
    step = _rows_per_chunk(b, 40 * cap)
    dds, dis = [], []
    for s in range(0, b, step):
        d = _adc_columns(lut[s:s + step], index)
        d = torch.where(alive[None, :], d, torch.inf)
        dd, di = _stable_top(d, ids.expand(d.shape[0], cap), fetch)
        dds.append(dd)
        dis.append(di)
    dco = alive.sum().to(torch.int32).expand(b).contiguous()
    return torch.cat(dds), torch.cat(dis), dco


def streaming_search(
    arrays: SeilArrays,
    centroids: torch.Tensor,      # (nlist, D)
    codebook: PQCodebook,
    vectors: torch.Tensor,        # (n_base + cap, D) refine store, id-aligned
    delta_codes: torch.Tensor,    # (cap, M) uint8 padded delta buffer
    delta_ids: torch.Tensor,      # (cap,) int32 global ids, -1 dead/unused
    delta_post: torch.Tensor,     # (nlist, L) int32 slot postings, -1 pad
    delta_assigns: torch.Tensor,  # (cap, m) int32 assigned lists per slot
    live: torch.Tensor,           # (n_base + cap,) bool tombstone mask
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
    route_delta: bool = False,
    fused_topk: bool = False,
    packed_codes: bool = False,   # arrays carry a nibble-packed plane
) -> SearchResult:
    fetch = finalize_fetch(bigk, oversample, dedup_results)
    selection = select_lists(queries, centroids, nprobe=nprobe, metric=metric)
    plan = plan_blocks(tables_from_arrays(arrays), selection,
                       max_scan=max_scan)
    lut = (pq_lut(codebook, queries) if metric == "l2"
           else pq_lut_ip(codebook, queries))
    if fused_topk:
        # live is applied before selection so tombstoned base candidates
        # cannot take top-fetch places; finalize's mask is idempotent
        scan = scan_blocks_topk(
            store_from_arrays(arrays), plan, lut, selection.rank_of,
            fetch=fetch, exec_mode=exec_mode, query_tile=query_tile,
            sel=selection.sel, live=live, packed=packed_codes)
    else:
        scan = scan_blocks(store_from_arrays(arrays), plan, lut,
                           selection.rank_of, exec_mode=exec_mode,
                           query_tile=query_tile, sel=selection.sel,
                           packed=packed_codes)
    dd, di, delta_dco, _ = _delta_candidates(
        lut, delta_codes, delta_ids, delta_post, delta_assigns,
        selection.sel, selection.rank_of, route_delta, fetch)
    out_ids, out_d, refine_dco = finalize_candidates(
        scan.flat_d, scan.flat_i, bigk=bigk, k=k, vectors=vectors,
        queries=queries, metric=metric, dedup_results=dedup_results,
        oversample=oversample, extra_d=dd, extra_i=di, live=live)
    return SearchResult(
        ids=out_ids, dists=out_d, approx_dco=scan.approx_dco + delta_dco,
        refine_dco=refine_dco, scanned_blocks=scan.scanned_blocks,
        dropped_blocks=plan.dropped)


def streaming_search_traced(
    arrays, centroids, codebook, vectors, delta_codes, delta_ids,
    delta_post, delta_assigns, live, queries, *, nprobe, bigk, k, max_scan,
    metric="l2", dedup_results=True, oversample=2, exec_mode="paged",
    query_tile=8, route_delta=False, fused_topk=False, packed_codes=False,
) -> SearchResult:
    """Stage-fenced ``streaming_search`` for tracing: the same
    composition, a span and a fence per stage, and the delta scan in a
    span of its own (``stage.delta_scan``; counters ``delta_dco``,
    ``kernel``: 1 where the delta scan's kernel ran, and on the routed
    path ``delta_walked``: posted slots read, summed over queries)."""
    fetch = finalize_fetch(bigk, oversample, dedup_results)
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
            packed_codes=packed_codes, live=live if fused_topk else None))
        sp.add(approx_dco=int(scan.approx_dco.sum()),
               scanned_blocks=int(scan.scanned_blocks.sum()))
    with obs.span("stage.delta_scan", cat="device",
                  routed=bool(route_delta)) as sp:
        launches = delta_scan_topk_kernel.launches
        dd, di, delta_dco, walked = obs.fence(_delta_candidates(
            lut, delta_codes, delta_ids, delta_post, delta_assigns,
            selection.sel, selection.rank_of, route_delta, fetch))
        sp.add(delta_dco=int(delta_dco.sum()),
               kernel=int(delta_scan_topk_kernel.launches > launches))
        if walked is not None:
            sp.add(delta_walked=int(walked.sum()))
    with obs.span("stage.finalize", cat="device") as sp:
        out_ids, out_d, refine_dco = obs.fence(finalize_candidates(
            scan.flat_d, scan.flat_i, bigk=bigk, k=k, vectors=vectors,
            queries=queries, metric=metric, dedup_results=dedup_results,
            oversample=oversample, extra_d=dd, extra_i=di, live=live))
        sp.add(refine_dco=int(refine_dco.sum()))
    return SearchResult(
        ids=out_ids, dists=out_d, approx_dco=scan.approx_dco + delta_dco,
        refine_dco=refine_dco, scanned_blocks=scan.scanned_blocks,
        dropped_blocks=plan.dropped)


def scan_finalize_stream(
    arrays: SeilArrays,
    vectors: torch.Tensor,
    delta_codes: torch.Tensor,
    delta_ids: torch.Tensor,
    delta_post: torch.Tensor,
    delta_assigns: torch.Tensor,
    live: torch.Tensor,
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
    route_delta: bool = False,
    fused_topk: bool = False,
    packed_codes: bool = False,
) -> SearchResult:
    """Streaming stages 3-4 against caller-provided (reused) unions: the
    probe half is the base ``probe_plan`` (the delta needs no block
    planning), so reused plans compose with churn unchanged."""
    fetch = finalize_fetch(bigk, oversample, dedup_results)
    scan = _stage_scan(
        arrays, probe.plan, probe.lut, probe.rank_of, fetch=fetch,
        exec_mode=exec_mode, query_tile=query_tile, fused_topk=fused_topk,
        perm=probe.perm, unions=unions, packed_codes=packed_codes,
        live=live if fused_topk else None)
    dd, di, delta_dco, _ = _delta_candidates(
        probe.lut, delta_codes, delta_ids, delta_post, delta_assigns,
        probe.sel, probe.rank_of, route_delta, fetch)
    out_ids, out_d, refine_dco = finalize_candidates(
        scan.flat_d, scan.flat_i, bigk=bigk, k=k, vectors=vectors,
        queries=queries, metric=metric, dedup_results=dedup_results,
        oversample=oversample, extra_d=dd, extra_i=di, live=live)
    return SearchResult(
        ids=out_ids, dists=out_d, approx_dco=scan.approx_dco + delta_dco,
        refine_dco=refine_dco, scanned_blocks=scan.scanned_blocks,
        dropped_blocks=probe.plan.dropped)
