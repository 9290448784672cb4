"""Bitonic selection network over (distance, position, id) triples.

The plain PyTorch form of the network the reference's fused kernel
runs (``repro/kernels/topk.py``).  Keys are lexicographic ``(d, pos)``
ascending; ``pos`` is unique among real candidates and padding carries
``(+inf, PAD_POS, -1)``, so the key is a total order and the network
needs no stability of its own.  The CUDA kernel
(``csrc/pq_scan_topk.cu``) runs these networks in shared memory: when
a candidate queue fills it takes ``bitonic_sort`` of the queue, then
``merge_topf`` of accumulator and queue.  No path of the port calls
the torch network: the plain K3 (``ref.py``) selects with a stable
``torch.sort``, which gives the same answer.  Only the tests run it,
against a numpy lexsort.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

# padding position for masked candidates; equal to the engine's BIG
PAD_POS = 2 ** 30


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (network widths must be powers of 2)."""
    p = 1
    while p < n:
        p *= 2
    return p


def _lex_le(ad, ap, bd, bp):
    """a precedes-or-equals b under the ascending (d, pos) lex key."""
    return (ad < bd) | ((ad == bd) & (ap <= bp))


def _compare_exchange(arrs: Sequence[torch.Tensor], kk: int, j: int
                      ) -> List[torch.Tensor]:
    """One bitonic substage: exchange at distance 2^j inside 2^kk blocks;
    a block is ascending iff bit (kk-1-j) of its outer index is 0."""
    n = arrs[0].shape[-1]
    g = 1 << j
    lead = tuple(arrs[0].shape[:-1])
    r = [x.reshape(lead + (n // (2 * g), 2, g)) for x in arrs]
    a = [x[..., 0, :] for x in r]
    b = [x[..., 1, :] for x in r]
    o = torch.arange(n // (2 * g), device=arrs[0].device)[:, None]
    asc = ((o >> (kk - 1 - j)) & 1) == 0
    a_first = _lex_le(a[0], a[1], b[0], b[1])
    take_a_lo = torch.where(asc, a_first, ~a_first)
    out = []
    for xa, xb in zip(a, b):
        lo = torch.where(take_a_lo, xa, xb)
        hi = torch.where(take_a_lo, xb, xa)
        out.append(torch.stack([lo, hi], dim=-2).reshape(lead + (n,)))
    return out


def _log2_exact(n: int, what: str) -> int:
    logn = n.bit_length() - 1
    if 1 << logn != n:
        raise ValueError(f"{what} needs a power-of-two width, got {n}")
    return logn


def bitonic_sort(arrs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Full ascending sort of (..., n) triples by the (d, pos) lex key."""
    logn = _log2_exact(arrs[0].shape[-1], "bitonic_sort")
    arrs = list(arrs)
    for kk in range(1, logn + 1):
        for j in range(kk - 1, -1, -1):
            arrs = _compare_exchange(arrs, kk, j)
    return arrs


def bitonic_merge(arrs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sort a *bitonic* (..., n) sequence ascending — log2(n) substages."""
    logn = _log2_exact(arrs[0].shape[-1], "bitonic_merge")
    arrs = list(arrs)
    for j in range(logn - 1, -1, -1):
        arrs = _compare_exchange(arrs, logn, j)
    return arrs


def merge_topf(acc: Sequence[torch.Tensor], new: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
    """Top-F of the union of two ascending (..., F) triples:
    ``concat(acc, reverse(new))`` is bitonic, one merge sorts it."""
    f = acc[0].shape[-1]
    cat = [torch.cat([a, x.flip(-1)], dim=-1) for a, x in zip(acc, new)]
    return [x[..., :f] for x in bitonic_merge(cat)]
