"""Stage 1 — centroid scoring and top-nprobe list selection (Alg. 2 L1)."""
from __future__ import annotations

import torch

from ..kmeans import pairwise_sq_l2
from .types import BIG, ListSelection


def rank_table(sel: torch.Tensor, nlist: int) -> torch.Tensor:
    """(B, P) ranked selected lists -> (B, nlist) rank (BIG if unselected)."""
    b, p = sel.shape
    ranks = torch.arange(p, dtype=torch.int32, device=sel.device).expand(b, p)
    table = torch.full((b, nlist), BIG, dtype=torch.int32, device=sel.device)
    return table.scatter_reduce(1, sel.long(), ranks, reduce="amin")


def select_lists(queries: torch.Tensor, centroids: torch.Tensor, *,
                 nprobe: int, metric: str = "l2") -> ListSelection:
    """Score list centroids, keep the top-nprobe per query (rank-ordered;
    equal distances keep the lower list id first, as ``lax.top_k``)."""
    cd = (pairwise_sq_l2(queries, centroids) if metric == "l2"
          else -(queries @ centroids.T))
    sel = torch.sort(cd, dim=1, stable=True).indices[:, :nprobe]
    sel = sel.to(torch.int32)
    return ListSelection(sel=sel, rank_of=rank_table(sel, centroids.shape[0]))
