"""The serve step behind ``ShardedIndex`` sessions (counterpart of
``repro/core/distributed.py``; ``core/sharded.py`` places the shards).

The reference runs one program per device under ``shard_map``.  The
port is single-controller in the same way, but without a device
runtime's SPMD: one process holds the shards in a list, in mesh order,
each shard's tensors on its own device (several shards may share a
device), and runs the per-shard half once per shard.  The reference's
collectives become explicit operations:

  * ``all_gather(tiled, axis=1)`` -> the shards' candidate streams
    concatenated in rank order on the result device (the queries'
    device, ``mesh.devices[0]``);
  * ``psum`` of the counters -> an integer sum over the shards;
  * ``pmin`` of the owner-scored exact distances -> ``torch.minimum``
    over the shards in rank order (``finalize_candidates(shards=...)``).

Sharding scheme (the reference's):
  * the flat block arrays shard by block-id range, every shard owning
    ``TBp / ndev`` rows of the block store padded to a multiple of
    ``ndev``; the list tables, centroids and PQ codebooks replicate;
  * the refine vectors shard by vector-id range over the same mesh;
  * the streaming state replicates: every shard masks with the whole
    tombstone bitmap, and delta slot ``s`` belongs to shard ``s % ndev``,
    so each delta id enters the gathered stream exactly once and each
    live slot's ADC distance is counted once.  A shard scores only the
    slots it owns (the reference scores every slot on every device and
    masks the others to +inf; the gathered candidates are the same).
    The delta scan is always the exhaustive one (``delta_adc``), as in
    the reference: above the routing threshold a sharded stream's DCO
    differs from the routed single-host stream's.

Per batch each shard composes the engine stages of the single-host
searcher: ``select_lists`` and the ADC tables (computed once per device
and shared by that device's shards, since they are replicated),
``plan_blocks`` windowed to the shard's block range, ``scan_blocks``
(K1) or ``scan_blocks_topk`` (K3) over the shard's own store at its
local shapes, and the stable top-``fetch`` ``preselect_candidates``
(span ``stage.shard_scan``).  The gather and ``finalize_candidates``
follow (span ``stage.gather_finalize``); each half is fenced, so while a
tracer is active (the session then runs the step eagerly) a trace
separates the shards' scan time from the merge tail.  Every selection is
stable by flat position and the gather is in rank order, so N shards
give the reference's answers at N devices bitwise, ties included; one
shard is bitwise the plain ``Searcher``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from .. import obs
from .engine import (BlockStore, ListTables, finalize_candidates,
                     plan_blocks, preselect_candidates, scan_blocks,
                     scan_blocks_topk, select_lists)
from .params import SearchParams
from .pq import PQCodebook, pq_lut, pq_lut_ip
from .search import SearchResult, finalize_fetch
from .stream.search import exhaustive_delta_candidates


class ShardArgs(NamedTuple):
    """One shard's tensors, all on the shard's device.  The block rows
    and the vector rows are the shard's own; everything else is a
    replica (frozen indexes carry zero-width delta tensors)."""
    block_codes: torch.Tensor   # (TBp / ndev, BLK, M) uint8
    block_ids: torch.Tensor     # (TBp / ndev, BLK) int32 global ids
    block_other: torch.Tensor   # (TBp / ndev, BLK) int32
    owned: torch.Tensor         # list tables, replicated
    owned_other: torch.Tensor
    refs: torch.Tensor
    refs_other: torch.Tensor
    misc: torch.Tensor
    centroids: torch.Tensor     # (nlist, D)
    codebooks: torch.Tensor     # (M, K, dsub)
    vectors: torch.Tensor       # (<= Np / ndev, D) global ids from vec_lo
    delta_codes: torch.Tensor   # (cap, M) uint8, replicated
    delta_ids: torch.Tensor     # (cap,) int32, -1 dead or unused
    live: torch.Tensor          # (n_total,) bool, (0,) when frozen


def shard_geometry(shards: Sequence[ShardArgs], rank: int):
    """``(block_lo, vec_lo)`` of shard ``rank``: the first global block id
    of its block rows and the first global id of its vector rows.  Every
    shard holds the same number of block rows, and every shard but the
    last the same number of vector rows (the last one's view stops at the
    store's end: an id past it is owned by no shard)."""
    return (rank * shards[0].block_ids.shape[0],
            rank * shards[0].vectors.shape[0])


def plan_shard(shard: ShardArgs, selection, *, block_lo: int,
               max_scan_local: int):
    """The shard's block store and its plan: the candidates windowed to
    its block range, ids rebased to its rows, compacted to the per-shard
    budget ``max_scan_local``."""
    store = BlockStore(block_codes=shard.block_codes,
                       block_ids=shard.block_ids,
                       block_other=shard.block_other)
    tables = ListTables(owned=shard.owned, owned_other=shard.owned_other,
                        refs=shard.refs, refs_other=shard.refs_other,
                        misc=shard.misc)
    plan = plan_blocks(tables, selection, max_scan=max_scan_local,
                       local_lo=block_lo,
                       local_count=shard.block_ids.shape[0])
    return store, plan


def build_serve_step(*, nprobe: int, bigk: int, k: int, max_scan_local: int,
                     metric: str = "l2", dedup_results: bool = False,
                     oversample: int = 2, exec_mode: str = "paged",
                     query_tile: int = 8, streaming: bool = False,
                     fused_topk: bool = False, packed_codes: bool = False):
    """The mesh's serve step.

    Returns ``serve(shards, queries) -> SearchResult``: ``shards`` the
    mesh's ``ShardArgs`` in mesh order, ``queries`` (B, D) on the
    result device, where the result lands.  With ``streaming=False`` the
    delta and live tensors are zero-width and unused.
    """
    fetch = finalize_fetch(bigk, oversample, dedup_results)

    def shard_scan(shard, rank, ndev, selection, lut, block_lo):
        store, plan = plan_shard(shard, selection, block_lo=block_lo,
                                 max_scan_local=max_scan_local)
        if fused_topk:
            # the fused stream is already the shard's stable top-fetch,
            # tombstones applied before the selection
            scan = scan_blocks_topk(
                store, plan, lut, selection.rank_of, fetch=fetch,
                exec_mode=exec_mode, query_tile=query_tile,
                sel=selection.sel, live=shard.live if streaming else None,
                packed=packed_codes)
        else:
            scan = scan_blocks(store, plan, lut, selection.rank_of,
                               exec_mode=exec_mode, query_tile=query_tile,
                               sel=selection.sel, packed=packed_codes)
        flat_d, flat_i, approx_dco = scan.flat_d, scan.flat_i, scan.approx_dco
        if streaming:
            # the slots this shard owns (s % ndev == rank), in slot order
            dd, di, delta_dco = exhaustive_delta_candidates(
                lut, shard.delta_codes[rank::ndev],
                shard.delta_ids[rank::ndev], fetch)
            flat_d = torch.cat([flat_d, dd], dim=1)
            flat_i = torch.cat([flat_i, di], dim=1)
            # the tombstones over the whole id space (idempotent on the
            # fused stream; the unfused one needs it)
            dead = (flat_i >= 0) & ~shard.live[flat_i.clamp_min(0).long()]
            flat_d = torch.where(dead, torch.inf, flat_d)
            approx_dco = approx_dco + delta_dco
        l_d, l_ids = preselect_candidates(flat_d, flat_i, fetch=fetch)
        return l_d, l_ids, approx_dco, scan.scanned_blocks, plan.dropped

    def scan_half(shards, queries):
        """Every shard through its preselect: ``(l_d, l_ids, approx_dco,
        scanned, dropped)``, the shards' candidate streams and the
        counters summed."""
        res = queries.device
        per_device = {}
        l_d, l_ids, counters = [], [], None
        for rank, shard in enumerate(shards):
            dev = shard.centroids.device
            if dev not in per_device:   # replicated: once per device
                q = queries.to(dev)
                selection = select_lists(q, shard.centroids, nprobe=nprobe,
                                         metric=metric)
                cb = PQCodebook(shard.codebooks)
                lut = pq_lut(cb, q) if metric == "l2" else pq_lut_ip(cb, q)
                per_device[dev] = (selection, lut)
            d, i, *cnt = shard_scan(shard, rank, len(shards),
                                    *per_device[dev],
                                    shard_geometry(shards, rank)[0])
            l_d.append(d)
            l_ids.append(i)
            cnt = [c.to(res) for c in cnt]
            counters = cnt if counters is None else [
                a + b for a, b in zip(counters, cnt)]
        return (l_d, l_ids, *counters)

    def tail_half(shards, queries, l_d, l_ids):
        res = queries.device
        g_d = torch.cat([d.to(res) for d in l_d], dim=1)
        g_ids = torch.cat([i.to(res) for i in l_ids], dim=1)
        return finalize_candidates(
            g_d, g_ids, bigk=bigk, k=k, vectors=None, queries=queries,
            metric=metric, dedup_results=dedup_results,
            oversample=oversample,
            shards=[(s.vectors, shard_geometry(shards, r)[1])
                    for r, s in enumerate(shards)])

    def serve(shards, queries):
        count = obs.recording()   # counters are host reads: only traced
        where = dict(bucket=queries.shape[0], ndev=len(shards))
        with obs.span("stage.shard_scan", cat="device", **where) as sp:
            l_d, l_ids, approx_dco, scanned, dropped = obs.fence(
                scan_half(shards, queries))
            if count:
                sp.add(approx_dco=int(approx_dco.sum()),
                       scanned_blocks=int(scanned.sum()))
        with obs.span("stage.gather_finalize", cat="device", **where) as sp:
            out_ids, out_d, refine_dco = obs.fence(
                tail_half(shards, queries, l_d, l_ids))
            if count:
                sp.add(refine_dco=int(refine_dco.sum()))
        return SearchResult(
            ids=out_ids, dists=out_d, approx_dco=approx_dco,
            refine_dco=refine_dco, scanned_blocks=scanned,
            dropped_blocks=dropped)

    return serve


# ---------------------------------------------------------------------------
# compat session wrapper (the reference's pre-ShardedIndex entry point)
# ---------------------------------------------------------------------------
def distributed_search(index, mesh, queries, *,
                       params: SearchParams = None,
                       nprobe: int = None, k: int = None,
                       k_factor: int = None, max_scan_local: int = 512,
                       axes=("data",), exec_mode: str = None,
                       query_tile: int = None) -> SearchResult:
    """Deprecated wrapper: shards ``index`` over ``mesh``
    (``index.shard``) and serves one batch through a ``ShardedIndex``
    session.  Prefer holding the session::

        sharded  = index.shard(mesh, axes=axes, max_scan_local=...)
        searcher = sharded.searcher(SearchParams(...))
        result   = searcher(queries)

    Query-side knobs come from ``params`` (individual kwargs override
    its fields); without ``params``, ``nprobe`` and ``k`` are required.
    ``max_scan_local`` is the per-shard plan budget, a property of the
    shard layout, so ``SearchParams.max_scan`` is refused."""
    if params is None:
        if nprobe is None or k is None:
            raise TypeError(
                "distributed_search requires nprobe= and k= when no "
                "params=SearchParams(...) is given")
        params = SearchParams()
    over = {name: v for name, v in (("nprobe", nprobe), ("k", k),
                                    ("k_factor", k_factor),
                                    ("exec_mode", exec_mode),
                                    ("query_tile", query_tile))
            if v is not None}
    if over:
        params = dataclasses.replace(params, **over)
    if params.max_scan is not None:
        # the wrapper always pins a per-shard budget, which would
        # silently override the per-query field: refuse instead
        raise ValueError(
            "distributed_search does not support SearchParams.max_scan; "
            "use max_scan_local= for the per-device plan budget (or hold "
            "a session: index.shard(mesh, max_scan_local=...)"
            ".searcher(params))")
    sharded = index.shard(mesh, axes=axes, max_scan_local=max_scan_local)
    return sharded.searcher(params)(queries)
