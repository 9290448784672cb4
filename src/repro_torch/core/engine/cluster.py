"""Query-tile clustering and tile unions — the locality-aware planner
(counterpart of ``repro/core/engine/cluster.py``).

Device half (torch): ``cluster_order`` buckets a batch by probed-list
overlap with a stable lexicographic sort over the first
``CLUSTER_DEPTH`` probe ranks; ``tile_unions`` builds one sorted,
duplicate-free block union per query tile.

Host half (numpy, driven by ``Searcher`` with ``plan_reuse``):
``merge_unions_host`` lets adjacent batches reuse (hit), extend or
replace (miss) the previous unions of a tile, ``plan_width`` picks the
smallest geometric width bucket covering the live entries (the scan
executable's dispatch width, ``width_buckets`` lists them all), and
``tile_signatures`` names each tile by what it probes, so the plan cache
follows the working set when a tile boundary moves.

Every valid planned block of a query lies in its tile's union (reused
or not), so the sorted-union ``searchsorted`` scatter recovers exactly
the paged distances.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .types import BIG

# probe ranks participating in the cluster signature
CLUSTER_DEPTH = 4

# incremental-plan cache tightness: a cached union may outgrow the
# batch's own working set by at most this factor (x own live entries)
# before it is rebuilt
EXTEND_SLACK = 2.0
_MIN_UNION = 32


def fit_tile(b: int, query_tile: int) -> int:
    """Largest tile size <= query_tile that divides the batch."""
    qt = max(1, min(query_tile, b))
    while b % qt:
        qt -= 1
    return qt


def union_dims(b: int, s: int, total_blocks: int, exec_mode: str,
               query_tile: int) -> Tuple[int, int]:
    """Static (n_tiles, width) of the union tensor for one batch shape.

    grouped:   one batch-wide union, width min(B*S, TB);
    clustered: one union per query tile, width min(tile*S, TB).
    """
    if exec_mode == "grouped":
        return 1, min(b * s, total_blocks)
    qt = fit_tile(b, query_tile)
    return b // qt, min(qt * s, total_blocks)


def cluster_order(sel: torch.Tensor) -> torch.Tensor:
    """sel (B, P) ranked probed lists -> perm (B,) int32 such that queries
    with equal probe-rank prefixes are adjacent; ties keep batch order.
    Successive stable sorts, least significant key first (= lexsort)."""
    depth = min(CLUSTER_DEPTH, sel.shape[1])
    perm = torch.arange(sel.shape[0], device=sel.device)
    for d in reversed(range(depth)):
        order = torch.sort(sel[perm, d], stable=True).indices
        perm = perm[order]
    return perm.to(torch.int32)


def tile_unions(blocks: torch.Tensor, valid: torch.Tensor, n_tiles: int,
                width: int) -> torch.Tensor:
    """blocks/valid (B, S) (already in cluster order) -> (n_tiles, width)
    ascending unique block ids, BIG-padded."""
    b, s = blocks.shape
    allb = torch.where(valid, blocks, torch.full_like(blocks, BIG))
    srt = torch.sort(allb.reshape(n_tiles, (b // n_tiles) * s), dim=1).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    uniq = torch.where(first & (srt < BIG), srt, torch.full_like(srt, BIG))
    return torch.sort(uniq, dim=1).values[:, :width].contiguous()


def union_live(unions):
    """(T, W) BIG-padded unions, a numpy array or a tensor -> (T,) live
    entry counts of the same kind."""
    return (unions < BIG).sum(axis=1)


def plan_width(live_max: int, width_cap: int) -> int:
    """Smallest width bucket covering ``live_max`` entries (the scan
    executable's dispatch width), capped at the static worst case; the
    buckets grow by 1.5x."""
    w = _MIN_UNION
    while w < live_max:
        w = w * 3 // 2
    return min(w, width_cap)


def width_buckets(width_cap: int) -> list:
    """Every dispatch width ``plan_width`` can produce for one static
    ``width_cap``: the 1.5x ladder clipped to the cap (what
    ``Searcher.warmup_widths`` captures)."""
    out = set()
    w = _MIN_UNION
    while w < width_cap:
        out.add(w)
        w = w * 3 // 2
    out.add(width_cap)
    return sorted(out)


def tile_signatures(lead_lists: np.ndarray, deep=None) -> list:
    """Stable identity keys for a batch's tiles, from the rank-0 probed
    list of each tile's first query (in cluster order): ``(lead list,
    run index)``, the run index separating consecutive tiles anchored on
    the same list.  ``deep`` (T, P), the full ranked probe row of each
    tile-lead query, widens the key with the probe prefix beyond the lead
    (ranks 1..CLUSTER_DEPTH-1): ``(lead, prefix, run)``."""
    leads = np.asarray(lead_lists).tolist()
    if deep is not None:
        d = np.asarray(deep)
        depth = min(CLUSTER_DEPTH, d.shape[1])
        fps = [tuple(r) for r in d[:, 1:depth].tolist()]
        sig = []
        run = 0
        for i, key in enumerate(zip(leads, fps)):
            run = run + 1 if i and key == sig[-1][:2] else 0
            sig.append((key[0], key[1], run))
        return sig
    sig = []
    run = 0
    for i, lst in enumerate(leads):
        run = run + 1 if i and lst == sig[-1][0] else 0
        sig.append((lst, run))
    return sig


def merge_unions_host(cached: Optional[np.ndarray], own: np.ndarray,
                      present: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Incremental-plan merge (host numpy, per dispatch bucket).

    cached/own: (T, W) sorted BIG-padded unions.  Per tile:
      * hit    — own is in cached and the cache is still tight (within
        ``EXTEND_SLACK`` x this batch's own live entries): reuse it;
      * extend — the merged live entries fit the width and the
        tightness bound: the cache grows;
      * miss   — cold cache, width overflow, or a bloated cache: this
        batch's own union replaces it.
    ``present`` masks rows that had a cached union (rows of first-seen
    tiles are BIG-filled and must count as misses).  Returns ``(used,
    hit, extend)``, used (T, W) the unions to scan and cache; every path
    keeps own in used.
    """
    t, w = own.shape
    big = int(BIG)
    if cached is None:
        return own, np.zeros(t, bool), np.zeros(t, bool)
    cat = np.concatenate([cached, own], axis=1)
    srt = np.sort(cat, axis=1)
    keep = srt < big
    keep[:, 1:] &= srt[:, 1:] != srt[:, :-1]
    live_merged = keep.sum(axis=1)
    tight = live_merged <= np.maximum(
        (union_live(own) * EXTEND_SLACK).astype(np.int64), _MIN_UNION)
    hit = (live_merged == union_live(cached)) & tight  # own added nothing
    fits = (live_merged <= w) & tight
    if present is not None:
        hit &= present
        fits &= present
    merged = np.full((t, w), big, srt.dtype)
    rows = np.nonzero(keep)[0]
    cols = (np.cumsum(keep, axis=1) - 1)[keep]
    sel = cols < w                                    # overflow rows ignored
    merged[rows[sel], cols[sel]] = srt[keep][sel]
    used = np.where(hit[:, None], cached,
                    np.where(fits[:, None], merged, own))
    return used, hit, fits & ~hit
