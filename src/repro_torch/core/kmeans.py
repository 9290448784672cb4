"""K-means (Lloyd's) for IVF list training and PQ sub-codebooks."""
from __future__ import annotations

from typing import Optional

import torch


def pairwise_sq_l2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances ||x - c||^2, shapes (n, D) x (k, D) -> (n, k)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)        # (n, 1)
    c2 = torch.sum(c * c, dim=-1)                       # (k,)
    xc = x @ c.T                                        # (n, k)
    return torch.clamp_min(x2 - 2.0 * xc + c2[None, :], 0.0)


def assign_nearest(x: torch.Tensor, c: torch.Tensor,
                   chunk: int = 16384) -> torch.Tensor:
    """argmin_k ||x - c_k||^2 (first minimum on ties), chunked over n to
    bound the (n, k) buffer.  -> (n,) int32."""
    outs = [torch.argmin(pairwise_sq_l2(x[s:s + chunk], c), dim=-1)
            for s in range(0, x.shape[0], chunk)]
    return torch.cat(outs).to(torch.int32)


def _update_centroids(x, assign, k, old_c):
    a = assign.long()
    sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    sums.index_add_(0, a, x)
    counts = torch.zeros((k,), dtype=x.dtype, device=x.device)
    counts.index_add_(0, a, torch.ones_like(x[:, 0]))
    new_c = sums / torch.clamp_min(counts, 1.0)[:, None]
    # keep empty clusters where they were (Faiss splits them; we freeze them)
    return torch.where((counts > 0)[:, None], new_c, old_c)


def kmeans_loop(x: torch.Tensor, init_c: torch.Tensor, iters: int,
                chunk: int = 16384) -> torch.Tensor:
    """``iters`` Lloyd steps from the given initial centroids."""
    c = init_c
    for _ in range(iters):
        c = _update_centroids(x, assign_nearest(x, c, chunk), c.shape[0], c)
    return c


def kmeans_fit(x: torch.Tensor, k: int, iters: int = 20, chunk: int = 16384,
               sample: Optional[int] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fit k centroids from random-point init (Faiss default for IVF
    training).  ``generator`` is a CPU generator: the sample and the
    initial points are drawn on the host and gathered on x's device."""
    n = x.shape[0]
    if sample is not None and sample < n:
        idx = torch.randperm(n, generator=generator)[:sample]
        xt = x[idx.to(x.device)]
    else:
        xt = x
    perm = torch.randperm(xt.shape[0], generator=generator)[:k]
    return kmeans_loop(xt, xt[perm.to(x.device)], iters, chunk)
