"""K-means (Lloyd's) for IVF list training and PQ sub-codebooks."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..kernels.ref import pairwise_sq_l2


def assign_nearest(x: torch.Tensor, c: torch.Tensor,
                   chunk: int = 16384) -> torch.Tensor:
    """argmin_k ||x - c_k||^2 (first minimum on ties), chunked over n to
    bound the (n, k) buffer.  -> (n,) int32."""
    outs = [torch.argmin(pairwise_sq_l2(x[s:s + chunk], c), dim=-1)
            for s in range(0, x.shape[0], chunk)]
    return torch.cat(outs).to(torch.int32)


def segment_sum(x: torch.Tensor, seg: torch.Tensor, k: int):
    """Per-segment row sums and counts in a fixed order:
    ``(sums (k, D), counts (k,))`` with ``sums[j]`` the sum of the rows
    of ``x`` whose ``seg`` is ``j``.

    The rows are stably sorted by segment and each segment is summed over
    its rows in ascending row order, starting from zero
    (``torch.segment_reduce``): the same order on every device and in
    every run.  On the CPU that is the order of the reference's
    ``jax.ops.segment_sum``, bitwise.  (``index_add_`` on a CUDA tensor
    sums f32 with atomics, in an order that changes between runs.)
    """
    s = seg.long()
    srt, order = torch.sort(s, stable=True)
    bounds = torch.searchsorted(
        srt, torch.arange(k + 1, dtype=torch.long, device=x.device))
    lengths = bounds[1:] - bounds[:-1]
    sums = torch.segment_reduce(x[order], "sum", lengths=lengths, axis=0,
                                unsafe=True)
    return sums, lengths.to(x.dtype)


def _update_centroids(x, assign, k, old_c):
    sums, counts = segment_sum(x, assign, k)
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


def kmeans_step_sharded(x_shards: Sequence[torch.Tensor],
                        c: torch.Tensor) -> torch.Tensor:
    """One Lloyd step over a corpus held as row shards, each on its own
    device (a mesh's shards, ``core/sharded.py``); the centroids ``c``
    are replicated.  Each shard assigns its rows and sums them in the
    fixed order of ``segment_sum``; the sums and counts are then added
    across the shards in mesh order on ``c``'s device (the reference's
    ``psum``), and empty clusters keep their centroid.  -> (k, D) on
    ``c``'s device."""
    k = c.shape[0]
    sums = counts = None
    for x in x_shards:
        s, n = segment_sum(x, assign_nearest(x, c.to(x.device)), k)
        s, n = s.to(c.device), n.to(c.device)
        sums = s if sums is None else sums + s
        counts = n if counts is None else counts + n
    new_c = sums / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where((counts > 0)[:, None], new_c, c)
