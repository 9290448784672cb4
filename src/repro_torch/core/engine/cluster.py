"""Query-tile clustering and tile unions — the device half of the
reference's locality-aware planner (``repro/core/engine/cluster.py``).

``cluster_order`` buckets a batch by probed-list overlap with a stable
lexicographic sort over the first ``CLUSTER_DEPTH`` probe ranks;
``tile_unions`` builds one sorted, duplicate-free block union per query
tile.  Every valid planned block of a query lies in its tile's union,
so the sorted-union ``searchsorted`` scatter recovers exactly the paged
distances.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .types import BIG

# probe ranks participating in the cluster signature
CLUSTER_DEPTH = 4


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


def union_live(unions: torch.Tensor) -> torch.Tensor:
    """(T, W) BIG-padded unions -> (T,) live entry counts."""
    return (unions < BIG).sum(dim=1)
